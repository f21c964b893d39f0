"""Command dispatcher: ``python -m gpsat_tpu_torch.cli <command> [...]``.

One entry point over the per-module CLIs, which stay invocable as
``python -m gpsat_tpu_torch.<command>`` (ref CLI scripts:
GPSat/read_and_store.py, GPSat/bin_data.py, GPSat/local_expert_oi.py,
GPSat/postprocessing.py). The JAX package's commands that the port does not
have yet print so and return 1; a command run without its config prints
its usage and returns 2.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "read_and_store": ("gpsat_tpu_torch.read_and_store", "raw flat files -> observations table"),
    "bin_data": ("gpsat_tpu_torch.bin_data", "bin observations onto a regular grid"),
    "local_expert_oi": ("gpsat_tpu_torch.local_expert_oi", "run local-expert optimal interpolation"),
    "postprocessing": ("gpsat_tpu_torch.postprocessing", "smooth hyperparameters / re-predict"),
}
NOT_PORTED = {
    "xval": "cross-validation expansion + evaluation",
    "prime_cache": "AOT-compile canonical bucket shapes into the cache",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        lines = "\n".join(f"  {name:<18} {desc}" for name, (_, desc) in COMMANDS.items())
        later = "\n".join(f"  {name:<18} {desc} (not ported yet)" for name, desc in NOT_PORTED.items())
        print(f"usage: python -m gpsat_tpu_torch.cli <command> [args]\n\ncommands:\n{lines}\n{later}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported yet; see ROADMAP.md Queue 1 item 9", file=sys.stderr)
        return 1
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}; run with --help for the list", file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(COMMANDS[cmd][0])
    sys.argv = [f"gpsat_tpu_torch.cli {cmd}"] + rest
    out = mod.main()
    return out if isinstance(out, int) else 0
