"""Auto-CLI (counterpart of ``lmc_atomi_tpu/utils/cli.py``, copied: that
package imports JAX): every keyword argument of the main function becomes
``--name value`` / ``--name=value``, typed from its default. Booleans accept
true/false/1/0; None-defaulted args are parsed as python literals.
``require_device`` is the workload CLIs' device rule: the card unless the
caller asks for the CPU; ``device_label`` names the card a result was taken on.
"""
from __future__ import annotations

import argparse
import ast
import inspect
import subprocess
from typing import Any, Callable

import torch


def _parse_none(v: str) -> Any:
    if v.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(v)
    except (SyntaxError, ValueError):
        return v


def _bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v}")


def auto_cli(fn: Callable, argv=None) -> Any:
    """Build an argparse CLI from ``fn``'s signature and invoke it."""
    sig = inspect.signature(fn)
    doc_lines = (fn.__doc__ or "").strip().splitlines()
    parser = argparse.ArgumentParser(
        prog=fn.__name__, description=doc_lines[0] if doc_lines else None
    )
    for name, p in sig.parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        flag = "--" + name
        if p.default is inspect.Parameter.empty:
            parser.add_argument(flag, required=True, type=_parse_none)
        elif isinstance(p.default, bool):
            parser.add_argument(flag, type=_bool, default=p.default)
        elif isinstance(p.default, int):
            parser.add_argument(flag, type=int, default=p.default)
        elif isinstance(p.default, float):
            parser.add_argument(flag, type=float, default=p.default)
        elif isinstance(p.default, str):
            parser.add_argument(flag, type=str, default=p.default)
        else:
            parser.add_argument(flag, type=_parse_none, default=p.default)
    args = vars(parser.parse_args(argv))
    return fn(**args)


def require_device(device: str, workload: str) -> torch.device:
    """``torch.device(device)``; raises when it names a CUDA device and
    there is none (a workload runs on the CPU only when asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: the {workload} workload runs on the card; pass "
            "device='cpu' (--device cpu) to run it on the CPU")
    return dev


def device_label(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (``"NVIDIA H100 80GB
    HBM3, 700.00 W"``) for a CUDA device, else the device's type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[dev.index or 0].strip()
