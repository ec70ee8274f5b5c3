"""Model zoo: one unified transformer covering the 10 assigned archs.

Counterpart of ``repro/models/``: the configuration and the forward of the
attention architectures (``transformer.init_params``, ``forward``,
``lm_loss``). Decoding and the train and serve steps are ROADMAP Queue 1
item 9d, the recurrent mixers item 9c.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer

__all__ = ["ModelConfig", "transformer"]
