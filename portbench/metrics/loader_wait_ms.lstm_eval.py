"""loader_wait_ms.lstm_eval: the mean milliseconds a step of the window
spent blocked in the full-frame loader's next(), by the benchmark's clock
around it."""

from portbench.readers import loader_wait_ms


def read(run):
    return loader_wait_ms(run)
