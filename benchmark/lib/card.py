"""The card: a run needs as many CUDA devices as its cell asks for and
never falls back to the CPU; `describe` names what ran."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < count:
        raise NoCard(f"the cell needs {count} CUDA devices, "
                     f"torch.cuda.device_count() is {have}")


def power_limit() -> str:
    """The first card's power limit as nvidia-smi prints it."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def describe(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit": power_limit()}
