"""Report publishing after training: the publisher gathers the
workflow's report, the backends render it (``veles_tpu/publishing/``'s
counterpart)."""

from veles_tpu_torch.publishing.publisher import Publisher  # noqa: F401
from veles_tpu_torch.publishing.backends import (  # noqa: F401
    ConfluenceBackend, MarkdownBackend, HTMLBackend, PDFBackend)
