"""The device a run used, as the result line reports it."""

from __future__ import annotations

import subprocess

import torch


def info(c, cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": c.chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": c.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, for the record."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
