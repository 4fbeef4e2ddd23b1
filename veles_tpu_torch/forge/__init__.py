"""Forge: the model-package hub (``veles_tpu/forge/``'s counterpart):
the server with plain or git-backed storage and its client."""

from veles_tpu_torch.forge.server import ForgeServer  # noqa: F401
from veles_tpu_torch.forge.client import (  # noqa: F401
    upload, fetch, list_packages, details)
