"""Dataset downloader.

Counterpart of ``veles_tpu/downloader.py``: fetch an archive from a URL
into a directory and unpack it (tar or zip), skipping the work when the
expected files are there.  ``file://`` URLs work as any other; where the
network is closed the fetch fails with a message, not a hang.
"""

import os
import tarfile
import urllib.request
import zipfile

from veles_tpu_torch.units import Unit

__all__ = ["Downloader"]


class Downloader(Unit):
    def __init__(self, workflow, **kwargs):
        super(Downloader, self).__init__(workflow, **kwargs)
        self.url = kwargs["url"]
        self.directory = kwargs.get("directory", ".")
        self.files = list(kwargs.get("files", ()))  # expected outputs

    @property
    def satisfied(self):
        return self.files and all(
            os.path.exists(os.path.join(self.directory, f))
            for f in self.files)

    def initialize(self, **kwargs):
        super(Downloader, self).initialize(**kwargs)
        if not self.satisfied:
            self.download()
        return True

    def download(self):
        os.makedirs(self.directory, exist_ok=True)
        name = os.path.basename(self.url.split("?")[0]) or "dataset"
        archive = os.path.join(self.directory, name)
        if not os.path.exists(archive):
            self.info("fetching %s", self.url)
            try:
                with urllib.request.urlopen(self.url, timeout=60) as r, \
                        open(archive, "wb") as out:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
            except OSError as exc:
                raise RuntimeError(
                    "download of %s failed (no network egress?): %s" %
                    (self.url, exc))
        self.unpack(archive)

    def unpack(self, archive):
        if tarfile.is_tarfile(archive):
            with tarfile.open(archive) as tar:
                tar.extractall(self.directory, filter="data")
        elif zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as z:
                z.extractall(self.directory)

    def run(self):
        pass
