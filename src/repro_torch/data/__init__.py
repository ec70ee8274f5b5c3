from repro_torch.data.pipeline import (
    DataConfig,
    TokenPipeline,
    malgen_token_stream,
)

__all__ = ["DataConfig", "TokenPipeline", "malgen_token_stream"]
