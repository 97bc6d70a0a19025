"""The example programs' shared command line."""

from __future__ import annotations

import argparse


def parse(doc: str, jsonl: bool = False) -> dict:
    """`--device` (default the card), and `--jsonl PATH` where the example writes one."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device to run on (default: the card)")
    if jsonl:
        p.add_argument("--jsonl", dest="jsonl_path", default=None, help="write one JSON line per sweep here")
    return vars(p.parse_args())
