"""HDFS loader over the WebHDFS REST gateway.

Counterpart of ``veles_tpu/loader/hdfs.py``: the WebHDFS v1 HTTP API
(``LISTSTATUS`` and ``OPEN``) through the standard library's urllib, no
hadoop client.  Each line of each file is one sample.  A
``FullBatchLoader``: on the card each minibatch is one
``gather_minibatch`` launch.
"""

import json
import posixpath
import urllib.parse
import urllib.request

import numpy

from veles_tpu_torch.loader.base import LoaderError
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

__all__ = ["WebHdfsClient", "HdfsTextLoader"]


class WebHdfsClient(object):
    """Minimal WebHDFS v1 client: LISTSTATUS + OPEN."""

    def __init__(self, base_url, user=None, timeout=30):
        # base_url like http://namenode:9870
        self.base_url = base_url.rstrip("/")
        self.user = user
        self.timeout = timeout

    def _url(self, path, op, **params):
        params = dict(params, op=op)
        if self.user:
            params["user.name"] = self.user
        return "%s/webhdfs/v1%s?%s" % (
            self.base_url, urllib.parse.quote(path),
            urllib.parse.urlencode(params))

    def list_status(self, path):
        """-> [{pathSuffix, type, length, ...}, ...]"""
        with urllib.request.urlopen(self._url(path, "LISTSTATUS"),
                                    timeout=self.timeout) as resp:
            payload = json.load(resp)
        return payload["FileStatuses"]["FileStatus"]

    def open(self, path):
        """-> file bytes (follows the datanode redirect)."""
        with urllib.request.urlopen(self._url(path, "OPEN"),
                                    timeout=self.timeout) as resp:
            return resp.read()

    def list_files(self, path, suffix=None):
        out = []
        for status in self.list_status(path):
            if status.get("type") != "FILE":
                continue
            name = status["pathSuffix"]
            if suffix and not name.endswith(suffix):
                continue
            out.append(posixpath.join(path, name))
        return sorted(out)


class HdfsTextLoader(FullBatchLoader):
    """Each LINE of each file under ``hdfs_path`` is one sample of
    whitespace-separated floats; the last column is the int label
    (set ``labeled=False`` for unlabeled data).

    kwargs: hdfs_url, hdfs_path, user, suffix (e.g. ".txt"),
    validation_ratio (split off the tail).
    """

    def __init__(self, workflow, **kwargs):
        super(HdfsTextLoader, self).__init__(workflow, **kwargs)
        self.hdfs_url = kwargs["hdfs_url"]
        self.hdfs_path = kwargs["hdfs_path"]
        self.user = kwargs.get("user")
        self.suffix = kwargs.get("suffix")
        self.labeled = kwargs.get("labeled", True)
        self.split_ratio = kwargs.get("validation_ratio") or 0.0

    def load_data(self):
        client = WebHdfsClient(self.hdfs_url, user=self.user)
        rows, labels = [], []
        for path in client.list_files(self.hdfs_path, self.suffix):
            for line in client.open(path).decode().splitlines():
                line = line.strip()
                if not line:
                    continue
                cols = line.split()
                if self.labeled:
                    labels.append(int(cols[-1]))
                    cols = cols[:-1]
                rows.append([float(c) for c in cols])
        if not rows:
            raise LoaderError("no samples under %s%s" %
                              (self.hdfs_url, self.hdfs_path))
        data = numpy.array(rows, self.dtype)
        n_valid = int(len(rows) * self.split_ratio)
        self.original_data = data
        if self.labeled:
            self.original_labels = labels
        self.class_lengths[0] = 0
        self.class_lengths[1] = n_valid
        self.class_lengths[2] = len(rows) - n_valid
        if n_valid:
            # validation window first (loader layout [test|valid|train])
            self.original_data = numpy.concatenate(
                [data[len(rows) - n_valid:], data[:len(rows) - n_valid]])
            if self.labeled:
                self.original_labels = (labels[len(rows) - n_valid:] +
                                        labels[:len(rows) - n_valid])
