"""Model zoo: one unified transformer covering the 10 assigned archs.

Counterpart of ``repro/models/``: the configuration and the forward of
all ten architectures (``transformer.init_params``, ``forward``,
``lm_loss``), the recurrent mixers included (``rglru``, ``rwkv6``).
Decoding and the train and serve steps are ROADMAP Queue 1 item 9d.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer

__all__ = ["ModelConfig", "transformer"]
