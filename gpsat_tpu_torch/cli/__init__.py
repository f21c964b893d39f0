"""Command dispatcher: ``python -m gpsat_tpu_torch.cli <command> [...]``.

One entry point over the per-module CLIs, which stay invocable as
``python -m gpsat_tpu_torch.<command>`` (ref CLI scripts:
GPSat/read_and_store.py, GPSat/bin_data.py, GPSat/local_expert_oi.py,
GPSat/postprocessing.py), and the cross-validation expansion and the
machine priming of the JAX package's ``gpsat_tpu.cli``. A command run
without its config prints its usage and returns 2.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "read_and_store": ("gpsat_tpu_torch.read_and_store", "raw flat files -> observations table"),
    "bin_data": ("gpsat_tpu_torch.bin_data", "bin observations onto a regular grid"),
    "local_expert_oi": ("gpsat_tpu_torch.local_expert_oi", "run local-expert optimal interpolation"),
    "postprocessing": ("gpsat_tpu_torch.postprocessing", "smooth hyperparameters / re-predict"),
    "xval": ("gpsat_tpu_torch.xval", "cross-validation expansion into hold-out OI configs"),
    "prime_cache": ("gpsat_tpu_torch.prime_cache", "build the libraries and warm the runner up per bucket shape"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        lines = "\n".join(f"  {name:<18} {desc}" for name, (_, desc) in COMMANDS.items())
        print(f"usage: python -m gpsat_tpu_torch.cli <command> [args]\n\ncommands:\n{lines}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}; run with --help for the list", file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(COMMANDS[cmd][0])
    sys.argv = [f"gpsat_tpu_torch.cli {cmd}"] + rest
    out = mod.main()
    return out if isinstance(out, int) else 0
