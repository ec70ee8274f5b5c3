"""Command-line preparse shared by the port's entry points.

Counterpart of ``repro/common/env.py``, keeping only what a torch process
needs: pulling a flag out of ``argv`` before ``argparse`` runs, so that the
launcher (``repro_torch.launch.coordinator``) can decide whether this
invocation forks a gang, joins one, or runs alone.

The JAX module's XLA-flag functions (``force_host_devices``,
``clear_forced_devices``, ``latency_hiding_flags``,
``enable_cpu_collectives`` and their helpers) have no counterpart: the JAX
package fakes P devices in one process through ``XLA_FLAGS``, which must be
set before its backend starts, while the port holds a process's nodes as
the leading ``[P]`` axis of its tensors (``repro_torch.common.nodes``) and
joins processes with ``torch.distributed`` over gloo, which reads no
environment flag.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def preparse_flag(name: str, default: Optional[str] = None,
                  argv: Optional[Sequence[str]] = None) -> Optional[str]:
    """Pull ``--name VALUE`` / ``--name=VALUE`` out of ``argv`` (default
    ``sys.argv``) before argparse runs. Like argparse, the LAST occurrence
    wins (the spawn parent relies on this: it appends rank flags to a
    re-invoked command line)."""
    argv = sys.argv if argv is None else list(argv)
    value = default
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            value = argv[i + 1]
        elif a.startswith(name + "="):
            value = a.split("=", 1)[1]
    return value


def preparse_int_flag(name: str, default: Optional[int] = None,
                      argv: Optional[Sequence[str]] = None) -> Optional[int]:
    """Integer-valued :func:`preparse_flag`."""
    raw = preparse_flag(name, None, argv)
    return default if raw is None else int(raw)


def preparse_nodes(default: int = 2,
                   argv: Optional[Sequence[str]] = None) -> int:
    """The shared ``--nodes`` preparse every CLI front-end uses."""
    return preparse_int_flag("--nodes", default, argv)
