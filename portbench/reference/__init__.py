"""The plain references the benchmark holds the program to: plain PyTorch,
float32 with TF32 off, importing nothing of the program."""
