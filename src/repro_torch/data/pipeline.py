"""Deterministic sharded token pipeline.

Counterpart of ``repro/data/pipeline.py``. Two sources:

- ``malgen``: the paper's generator as a corpus. MalGen event records are
  rendered to their 100-byte fixed-width ASCII lines (malgen/records.py)
  and byte-tokenized, so a language model learns on MalStone log data.
  Each batch is one virtual shard of ``generate_shard`` on the pipeline's
  device (on the card its sites are K6's), copied to the host once,
  encoded, and taken modulo the vocabulary. The global marked stream
  depends only on the seed, so it is made once, with the seed, and every
  batch slices it (the JAX package regenerates it on every call: the same
  records, one more site sampling a batch).
- ``synthetic``: uniform tokens for pure-throughput runs, from one
  ``torch.Generator`` a (seed, step, shard), seeded by
  ``malgen/seeding.py:stream_generator``. The step and the shard are
  mixed into one stream id, so a shard's tokens do not depend on the
  number of shards (as JAX's ``fold_in(fold_in(key, step), shard)``).
  The tokens are drawn on a CPU generator and then moved (16 KB a step at
  the launcher's defaults), so a batch is the same on every device. They
  are not JAX's tokens: no threefry is ported.

Determinism contract: batch ``i`` of shard ``h`` is a pure function of
(seed, i, h) and, for the malgen source, of the device it was drawn on
(the card's and the CPU's generators differ). That is what makes restarts
and straggler reassignment reproducible (runtime/trainer.py relies on it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.malgen.generator import generate_shard
from repro_torch.malgen.records import encode_records
from repro_torch.malgen.seeding import (
    EventDraws,
    MalGenConfig,
    SeedInfo,
    draw_events,
    make_seed_with_marked,
    marked_event_stream,
    stream_generator,
)

# the malgen source's seed budget and virtual shard count (JAX's)
MALGEN_SEED_RECORDS = 1 << 20
MALGEN_SHARDS = 65536


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"          # "synthetic" | "malgen"
    vocab_size: int = 256
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    malgen: Optional[MalGenConfig] = None


class TokenPipeline:
    """``{tokens, labels}`` batches with a deterministic step -> batch
    mapping, on ``device`` (the card unless ``device="cpu"``). ``shard`` /
    ``num_shards`` slice the global batch for multi-host loading.

    For the malgen source, ``seed`` and ``marked`` replace the seed tables
    and the global marked stream the constructor would make (tables made
    elsewhere, as ``malgen.seed_from_numpy`` gives them); the pipeline
    keeps them, on its device, as ``malgen_seed`` and ``marked``."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 device=None, *, seed: Optional[SeedInfo] = None,
                 marked=None):
        if num_shards < 1 or cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {num_shards} shards")
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range for {num_shards}")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.device = resolve_device(device)
        self.malgen_seed: Optional[SeedInfo] = None
        if cfg.source == "malgen":
            self.malgen_cfg = cfg.malgen or MalGenConfig(
                num_sites=10_000, num_entities=100_000)
            if seed is None:
                seed, marked = make_seed_with_marked(
                    cfg.seed, self.malgen_cfg, MALGEN_SEED_RECORDS,
                    device=self.device)
            seed = seed.to(self.device)
            if marked is None:
                marked = marked_event_stream(seed, self.malgen_cfg)
            self.malgen_seed = seed
            self.marked = tuple(x.to(self.device) for x in marked)
        elif cfg.source != "synthetic":
            raise ValueError(cfg.source)

    def batch_at(self, step: int) -> dict:
        toks = self.tokens_at(step)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def tokens_at(self, step: int, *,
                  unmarked: Optional[EventDraws] = None) -> torch.Tensor:
        """int32 ``[local_batch, seq_len + 1]``: batch ``step`` before the
        next-token split. ``unmarked`` (malgen only) replaces the virtual
        shard's unmarked draws (``malgen_draws``)."""
        if self.cfg.source == "synthetic":
            if unmarked is not None:
                raise ValueError("unmarked draws belong to the malgen source")
            return self._synthetic_tokens(step)
        return self._malgen_tokens(step, unmarked)

    def _synthetic_tokens(self, step: int) -> torch.Tensor:
        if not (0 <= step < 1 << 31 and self.shard < 1 << 32):
            raise ValueError(f"step {step} or shard {self.shard} outside "
                             f"the synthetic source's stream ids")
        g = stream_generator(self.cfg.seed, "token_synthetic",
                             (step << 32) | self.shard, "cpu")
        toks = torch.randint(0, self.cfg.vocab_size,
                             (self.local_batch, self.cfg.seq_len + 1),
                             generator=g, dtype=torch.int32)
        return toks.to(self.device)

    def _malgen_layout(self, step: int) -> tuple[int, int, int]:
        """(bytes needed, records generated, virtual shard id) of a
        step."""
        need = self.local_batch * (self.cfg.seq_len + 1)
        virtual_shard = step * self.num_shards + self.shard
        return need, (need + 99) // 100 + 1, virtual_shard % MALGEN_SHARDS

    def malgen_draws(self, step: int) -> EventDraws:
        """The unmarked draws batch ``step`` makes on the pipeline's
        device."""
        _, n_rec, shard_id = self._malgen_layout(step)
        n_marked = len(range(shard_id, self.malgen_seed.num_marked_events,
                             MALGEN_SHARDS))
        return draw_events(self.malgen_seed.rng_seed, "unmarked", shard_id,
                           n_rec - n_marked, self.malgen_cfg, self.device)

    def _malgen_tokens(self, step: int,
                       unmarked: Optional[EventDraws]) -> torch.Tensor:
        need, n_rec, shard_id = self._malgen_layout(step)
        log = generate_shard(self.malgen_seed, self.malgen_cfg, shard_id,
                             MALGEN_SHARDS, n_rec, marked=self.marked,
                             unmarked=unmarked)
        cols = torch.stack([log.event_seq, log.shard_hash, log.timestamp,
                            log.site_id, log.entity_id, log.mark]).cpu()
        blob = encode_records(*cols.numpy())
        toks = (np.frombuffer(blob, np.uint8)[:need].astype(np.int32)
                % self.cfg.vocab_size)
        return torch.from_numpy(toks.reshape(
            self.local_batch, self.cfg.seq_len + 1)).to(self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def malgen_token_stream(cfg: DataConfig, steps: int, shard: int = 0,
                        num_shards: int = 1, device=None):
    """Convenience: list of ``steps`` batches from the malgen source."""
    pipe = TokenPipeline(dataclasses.replace(cfg, source="malgen"), shard,
                         num_shards, device)
    return [pipe.batch_at(i) for i in range(steps)]
