from repro_torch.malgen.generator import generate_shard, generate_shards_device
from repro_torch.malgen.seeding import (
    EventDraws,
    MalGenConfig,
    SeedInfo,
    SiteDraws,
    make_seed,
    seed_from_numpy,
)

__all__ = ["EventDraws", "MalGenConfig", "SeedInfo", "SiteDraws",
           "generate_shard", "generate_shards_device", "make_seed",
           "seed_from_numpy"]
