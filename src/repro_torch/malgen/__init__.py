from repro_torch.malgen.generator import (
    chunk_shard_hash,
    generate_chunk,
    generate_chunked_log,
    generate_chunks,
    generate_shard,
    generate_shards_device,
)
from repro_torch.malgen.seeding import (
    ChunkMarkDraws,
    EventDraws,
    MalGenConfig,
    SeedInfo,
    SiteDraws,
    chunk_marked_records,
    make_seed,
    make_seed_streaming,
    seed_from_numpy,
)

__all__ = ["ChunkMarkDraws", "EventDraws", "MalGenConfig", "SeedInfo",
           "SiteDraws", "chunk_marked_records", "chunk_shard_hash",
           "generate_chunk", "generate_chunked_log", "generate_chunks",
           "generate_shard", "generate_shards_device", "make_seed",
           "make_seed_streaming", "seed_from_numpy"]
