"""Dataset integrity checker.

Rebuild of `hash_check_redownload.py`:
md5-verifies downloaded YT8M shards against a JSON manifest
({filename: md5hex}) and prints the re-download commands for mismatches
(printed, not run). A copy of the JAX package's cli/hash_check.py.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def md5_of(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    parser = argparse.ArgumentParser("Verify dataset shard md5s")
    parser.add_argument("--manifest", required=True,
                        help="JSON file: {filename: md5hex}")
    parser.add_argument("--data_dir", default=".")
    parser.add_argument("--redownload_base", default="")
    args = parser.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)
    bad = []
    for fname, want in sorted(manifest.items()):
        path = os.path.join(args.data_dir, fname)
        if not os.path.exists(path):
            print(f"MISSING {fname}")
            bad.append(fname)
            continue
        got = md5_of(path)
        if got != want:
            print(f"MISMATCH {fname}: got {got}, want {want}")
            bad.append(fname)
    if bad and args.redownload_base:
        for fname in bad:
            print(f"curl -O {args.redownload_base}/{fname}")
    print(f"{len(manifest) - len(bad)}/{len(manifest)} shards OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
