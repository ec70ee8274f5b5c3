from repro_torch.malgen.generator import (
    chunk_shard_hash,
    generate_chunk,
    generate_chunked_log,
    generate_chunks,
    generate_shard,
    generate_shards_device,
)
from repro_torch.malgen.powerlaw import (
    power_law_cdf,
    power_law_weights,
    sample_sites,
)
from repro_torch.malgen.records import (
    RECORD_BYTES,
    decode_records,
    encode_records,
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
    make_seed_with_marked,
    seed_from_numpy,
)

__all__ = ["ChunkMarkDraws", "EventDraws", "MalGenConfig", "RECORD_BYTES",
           "SeedInfo", "SiteDraws", "chunk_marked_records",
           "chunk_shard_hash", "decode_records", "encode_records",
           "generate_chunk", "generate_chunked_log", "generate_chunks",
           "generate_shard", "generate_shards_device", "make_seed",
           "make_seed_streaming", "make_seed_with_marked", "power_law_cdf",
           "power_law_weights", "sample_sites", "seed_from_numpy"]
