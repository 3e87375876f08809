"""The port's models; ``build(cfg)`` gives any registry config's uniform API."""
from repro_torch.models.model import Model, build  # noqa: F401
