"""Model zoo: one unified transformer covering the 10 assigned archs.

Counterpart of ``repro/models/``: the configuration and the forward of
all ten architectures (``transformer.init_params``, ``forward``,
``lm_loss``), the recurrent mixers included (``rglru``, ``rwkv6``), the
serving path (``decoding``: the fused prefill and the decode step) and
the train and serve step builders (``steps``).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer
from repro_torch.models import decoding
from repro_torch.models import steps

__all__ = ["ModelConfig", "transformer", "decoding", "steps"]
