"""Small sizes the CPU tests run the cells at: the configurations' widths
cut, the pool and the window short, float32 unless asked. `bench()` is
BENCHMARK.json with the cells the benchmark holds back (their files are
kept; PERF.md says why) added, so that their drivers are tested too."""

import json

from portbench import run


def bench():
    return run.with_held_back(json.loads((run.ROOT / "BENCHMARK.json").read_text()))


SMALL = {"feature_sizes": "12, 4", "num_classes": 32, "max_num_frames": 40,
         "lstm_cells": 8, "num_inputs_to_lstm": 4, "num_inputs_L1": 2, "every_n": 2,
         "batch_size": 8, "num_readers": 2}


def resize(spec, config, traffic, dtype="float32"):
    config["flags"].update(SMALL, compute_dtype=dtype)
    traffic.update(videos=64, shards=2, seconds=[10, 60])
    if "shuffle_buffer" in traffic:
        traffic["shuffle_buffer"] = 16
    if traffic["kind"] == "open_loop":
        traffic.update(rate=40, requests=8)
    spec["trace"] = {"span_s": 0.5}
    spec["check"]["batches" if "batches" in spec["check"] else "requests"] = 3
