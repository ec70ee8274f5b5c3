"""Pass registry and rule catalog of the port's static checker suite.

Counterpart of ``repro/analysis/registry.py``. A *pass* is a callable
``(AnalysisContext) -> list[Finding]`` registered under a family
(``drivers`` / ``kernels`` / ``collectives`` / ``lint``). The CLI's
``--target`` selects families; ``all`` runs every registered pass. Every
rule id a pass can emit is documented in :data:`RULES`: the registry
refuses passes that declare undocumented rules, so the README's table can
never silently drift from the code.

The JAX package's VMEM budget has no counterpart. Its place is taken by
Hopper's launch limits (the module constants below), which the kernel
passes check every launch plan against.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.analysis.findings import Finding

# Rule catalog: id -> one-line description.
RULES = {
    # driver passes (run every engine x backend eagerly at a tiny size)
    "DR001": "driver raises at the tiny geometry",
    "DR002": "a HistogramState / carry / ShuffleStats field changes dtype "
             "across a fold or differs from its declared dtype (a silent "
             "promotion of the carry)",
    "DR004": "host syncs over the budget the target declares",
    # kernel passes (launch plans of the eight CUDA kernels, no launch)
    "KG001": "grid or block the launch cannot take, or a tile grid that "
             "does not cover every record or site",
    "KG002": "element offset the kernel forms past the index type it uses "
             "for that array",
    "KG003": "shared memory over what the launch may have: over 48 KB "
             "without an opt-in, over 227 KB a block, or a promised "
             "occupancy that does not fit the SM's 228 KB",
    # collective passes (recorded collectives of the exchanges and a gang)
    "CL001": "exchange round's all_to_all with no global_count after it "
             "in the same round",
    "CL002": "collective staged through the host in a group of one "
             "process",
    "CL003": "rounds run differ from ShuffleStats.rounds or exceed "
             "expected_shuffle_rounds",
    "CL004": "collective dtype missing from the byte table the exchange "
             "clock counts with",
    "CL005": "ranks of a gang record different sequences of collectives",
    # lint passes (source tree invariants)
    "LN001": "bare assert in src/ (vanishes under python -O)",
}

FAMILIES = ("drivers", "kernels", "collectives", "lint")


# The launch limits of compute capability 9.0 (CUDA C++ Programming Guide,
# "Technical Specifications per Compute Capability").
# maximum number of threads per block
MAX_THREADS_PER_BLOCK = 1024
# maximum x-dimension of a grid of thread blocks
MAX_GRID_X = 2**31 - 1
# maximum y- or z-dimension of a grid of thread blocks
MAX_GRID_YZ = 65535
# warp size
WARP_SIZE = 32
# dynamic shared memory a block gets without
# cudaFuncAttributeMaxDynamicSharedMemorySize
SMEM_DEFAULT = 48 * 1024
# maximum amount of shared memory per thread block (227 KB, opt-in)
SMEM_PER_BLOCK_OPTIN = 232_448
# maximum amount of shared memory per SM (228 KB)
SMEM_PER_SM = 233_472
# shared memory the card reserves for each resident block (1 KB)
SMEM_RESERVED_PER_BLOCK = 1024
# maximum number of resident threads per SM
MAX_THREADS_PER_SM = 2048

# the families that run programs, and so need a device
DEVICE_FAMILIES = ("drivers", "collectives")


@dataclasses.dataclass
class AnalysisContext:
    """Options and shared state threaded through every pass."""

    # the device the driver and collective passes run their programs on
    # (None where only the kernel and lint families run: they run none)
    device: Optional[object]
    # source root for the lint passes (None: this package's src/repro_torch)
    src_root: Optional[str] = None
    # artifacts shared between the passes of a family
    cache: dict = dataclasses.field(default_factory=dict)
    # per-pass notes (skips, counts) for the CLI summary
    notes: list = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        self.notes.append(msg)


@dataclasses.dataclass(frozen=True)
class AnalysisPass:
    name: str
    family: str
    rules: tuple
    run: Callable[[AnalysisContext], list]
    doc: str = ""


_PASSES: dict[str, AnalysisPass] = {}


def register_pass(name: str, family: str, rules: tuple, doc: str = ""):
    """Decorator: register ``fn(ctx) -> list[Finding]`` as a pass."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    undocumented = [r for r in rules if r not in RULES]
    if undocumented:
        raise ValueError(
            f"pass {name!r} declares undocumented rules {undocumented}; "
            f"add them to repro_torch.analysis.registry.RULES first")

    def deco(fn):
        if name in _PASSES:
            raise ValueError(f"duplicate pass name {name!r}")
        _PASSES[name] = AnalysisPass(name=name, family=family,
                                     rules=tuple(rules), run=fn,
                                     doc=doc or (fn.__doc__ or "").strip())
        return fn

    return deco


def _load_all() -> None:
    """Import every pass module (registration happens at import)."""
    from repro_torch.analysis import collective_passes  # noqa: F401
    from repro_torch.analysis import driver_passes      # noqa: F401
    from repro_torch.analysis import kernel_passes      # noqa: F401
    from repro_torch.analysis import lint               # noqa: F401


def iter_passes(families=None) -> list[AnalysisPass]:
    _load_all()
    fams = set(families or FAMILIES)
    unknown = fams - set(FAMILIES)
    if unknown:
        raise ValueError(f"unknown analysis families {sorted(unknown)}; "
                         f"have {FAMILIES}")
    return [p for p in _PASSES.values() if p.family in fams]


def run_passes(families, ctx: AnalysisContext) -> list[Finding]:
    """Run the selected pass families (None: all) and return all
    findings."""
    findings: list[Finding] = []
    for p in iter_passes(families):
        found = p.run(ctx)
        bad = [f for f in found if f.rule not in p.rules]
        if bad:
            raise RuntimeError(
                f"pass {p.name!r} emitted undeclared rules "
                f"{sorted({f.rule for f in bad})}")
        findings.extend(found)
    return findings
