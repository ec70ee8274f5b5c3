"""Deprecation shim: the LLM decoding launcher moved to
``repro_torch.launch.serve_lm`` (the ``serve`` name was too easy to
confuse with the MalStone query service,
``repro_torch.launch.serve_malstone``). Importing from here keeps working
but warns; ``python -m repro_torch.launch.serve`` still runs the LM
launcher."""

import warnings

from repro_torch.launch.serve_lm import main  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve moved to repro_torch.launch.serve_lm (the "
    "MalStone serving engine is repro_torch.launch.serve_malstone); this "
    "shim will be removed in a future release",
    DeprecationWarning, stacklevel=2)

__all__ = ["main"]

if __name__ == "__main__":
    main()
