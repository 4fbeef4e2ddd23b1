"""Forge server: the package registry over HTTP.

Counterpart of ``veles_tpu/forge/server.py``: versioned directories
(<root>/<name>/<version>/package.tar + metadata.json) by default, or,
with ``git_backed=True``, one git repository a package whose worktree
holds the latest files and whose ``v/<version>`` tags hold the history.
It serves on the standard library's ``http.server``
(:mod:`veles_tpu_torch.http_util`) with the JAX package's endpoints,
status codes and headers; an upload past 1 GiB (tornado's
``max_buffer_size`` there) is refused with 400 before its body is read.
Endpoints:

  GET  /service?query=list                  -> JSON package index
  GET  /service?query=details&name=N        -> metadata + versions
  GET  /fetch?name=N[&version=V]            -> package bytes (latest)
  POST /upload?name=N&version=V             -> store package (body)

Versions order by natural numeric sort ("1.9.0" < "1.10.0"); "latest"
resolves to the numerically greatest version everywhere: index,
details and fetch agree.  ``upload_token`` (default
``$VELES_FORGE_TOKEN``): when set, an upload needs ``Authorization:
Bearer <token>``, compared with ``hmac.compare_digest``.  A host
service: it touches no device.
"""

import hmac
import json
import os
import re
import subprocess
from urllib.parse import parse_qs, urlsplit

from veles_tpu_torch.logger import Logger

__all__ = ["ForgeServer"]

# Package names and versions become path components; anything outside
# this alphabet (or a leading dot) is rejected to block traversal.
_SAFE_COMPONENT = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._+-]*\Z")


def _safe_component(value, what):
    if not _SAFE_COMPONENT.match(value or "") or ".." in value:
        raise ValueError("illegal %s %r" % (what, value))
    return value


def _version_key(version):
    # natural sort: "1.10.0" > "1.9.0"
    return [int(part) if part.isdigit() else part
            for part in re.split(r"(\d+)", version)]


#: the largest upload body (tornado's max_buffer_size in the JAX package)
MAX_BODY = 1 << 30


class _MissingArgument(Exception):
    pass


class ForgeServer(Logger):
    """The package registry; ``start_background()`` serves it."""

    def __init__(self, root_dir, port=0, upload_token=None,
                 git_backed=False):
        super(ForgeServer, self).__init__()
        self.root_dir = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.port = port
        self.upload_token = (upload_token if upload_token is not None
                             else os.environ.get("VELES_FORGE_TOKEN"))
        self.git_backed = git_backed
        self._server_ = None
        # per-package version-list cache: ``git tag --list`` is a
        # subprocess spawn, and index() calls versions() for every
        # package on every /service?query=list — without the cache the
        # endpoint is O(packages) process spawns per request.  The
        # server owns the store, so store() is the only invalidation
        # point needed.
        self._versions_cache = {}

    # -- git backing ----------------------------------------------------------

    def _git(self, name, *args, binary=False):
        pdir = os.path.join(self.root_dir,
                            _safe_component(name, "package name"))
        env = dict(os.environ,
                   GIT_CONFIG_GLOBAL=os.devnull,
                   GIT_CONFIG_SYSTEM=os.devnull)
        try:
            out = subprocess.run(
                ["git", "-C", pdir, "-c", "user.name=forge",
                 "-c", "user.email=forge@localhost",
                 # payloads are binary: host autocrlf/gitattributes
                 # must never rewrite them
                 "-c", "core.autocrlf=false"] + list(args),
                capture_output=True, check=True, env=env)
        except FileNotFoundError:
            raise RuntimeError("git binary not available "
                               "(git_backed forge requires it)")
        except subprocess.CalledProcessError as exc:
            stderr = exc.stderr.decode(errors="replace").strip()
            self.warning("git %s failed for %s: %s",
                         args[0] if args else "", name, stderr)
            raise RuntimeError("git %s failed: %s"
                               % (args[0] if args else "", stderr))
        return out.stdout if binary else out.stdout.decode()

    def _git_store(self, name, version, payload, meta):
        pdir = os.path.join(self.root_dir,
                            _safe_component(name, "package name"))
        _safe_component(version, "version")
        # drop the cached version list up front: even a failed store
        # may have advanced the underlying repo (e.g. crash between
        # commit and tag), so the next read must re-list
        self._versions_cache.pop(name, None)
        os.makedirs(pdir, exist_ok=True)
        if not os.path.isdir(os.path.join(pdir, ".git")):
            self._git(name, "init", "-q")
        if version in self._git_versions(name):
            raise ValueError("version %s already published" % version)
        with open(os.path.join(pdir, "package.tar"), "wb") as fout:
            fout.write(payload)
        with open(os.path.join(pdir, "metadata.json"), "w") as fout:
            json.dump(meta, fout, indent=1, sort_keys=True)
        self._git(name, "add", "-A")
        # --allow-empty: a crash between commit and tag leaves the
        # version unpublished (no tag) but retriable — the retry's
        # identical content still commits and the tag lands
        self._git(name, "commit", "-q", "--allow-empty",
                  "-m", version)
        self._git(name, "tag", "v/%s" % version)
        # the already-published check above re-populated the cache
        # with the pre-tag list — drop it again now that the tag lands
        self._versions_cache.pop(name, None)

    def _git_versions(self, name):
        cached = self._versions_cache.get(name)
        if cached is not None:
            return list(cached)
        versions = self._git_versions_uncached(name)
        self._versions_cache[name] = list(versions)
        return versions

    def _git_versions_uncached(self, name):
        pdir = os.path.join(self.root_dir,
                            _safe_component(name, "package name"))
        if not os.path.isdir(os.path.join(pdir, ".git")):
            if os.path.isdir(pdir) and os.listdir(pdir):
                # plain-directory versions from a non-git deployment:
                # hiding them (or committing them as junk) would be
                # silent data loss — refuse loudly
                raise RuntimeError(
                    "package %r holds non-git version directories; "
                    "migrate them or run without git_backed" % name)
            return []
        tags = self._git(name, "tag", "--list", "v/*").split()
        return sorted((t[2:] for t in tags), key=_version_key)

    def _git_show(self, name, version, filename, binary=False):
        return self._git(
            name, "show", "v/%s:%s" % (
                _safe_component(version, "version"), filename),
            binary=binary)

    # -- storage ------------------------------------------------------------

    def _package_dir(self, name, version):
        path = os.path.join(self.root_dir,
                            _safe_component(name, "package name"),
                            _safe_component(version, "version"))
        root = os.path.realpath(self.root_dir)
        if not os.path.realpath(path).startswith(root + os.sep):
            raise ValueError("package path escapes root_dir")
        return path

    def versions(self, name):
        if self.git_backed:
            return self._git_versions(name)
        pdir = os.path.join(self.root_dir,
                            _safe_component(name, "package name"))
        if not os.path.isdir(pdir):
            return []
        return sorted(os.listdir(pdir), key=_version_key)

    def store(self, name, version, payload, metadata=None):
        meta = dict(metadata or {})
        meta.update({"name": name, "version": version,
                     "size": len(payload)})
        if self.git_backed:
            self._git_store(name, version, payload, meta)
            self.info("stored %s==%s (%d bytes, git)", name, version,
                      len(payload))
            return
        pdir = self._package_dir(name, version)
        os.makedirs(pdir, exist_ok=True)
        with open(os.path.join(pdir, "package.tar"), "wb") as fout:
            fout.write(payload)
        with open(os.path.join(pdir, "metadata.json"), "w") as fout:
            json.dump(meta, fout, indent=1, sort_keys=True)
        self.info("stored %s==%s (%d bytes)", name, version,
                  len(payload))

    def _worktree_version(self, name):
        """Version held by the git worktree (= most recent upload),
        or None."""
        path = os.path.join(
            self.root_dir, _safe_component(name, "package name"),
            "metadata.json")
        try:
            with open(path) as fin:
                return json.load(fin).get("version")
        except (OSError, ValueError):
            return None

    def load(self, name, version="latest"):
        if version == "latest":
            versions = self.versions(name)
            if not versions:
                raise KeyError("unknown package %s" % name)
            version = versions[-1]
        if self.git_backed:
            if version == self._worktree_version(name):
                # worktree fast path, but only when it actually holds
                # the requested version — out-of-order uploads (1.0.1
                # backfilled after 1.1.0) leave the worktree behind
                # "latest" and must go through the tag
                pdir = os.path.join(
                    self.root_dir,
                    _safe_component(name, "package name"))
                with open(os.path.join(pdir, "package.tar"),
                          "rb") as fin:
                    return fin.read(), version
            if version not in self._git_versions(name):
                raise KeyError("unknown version %s" % version)
            return (self._git_show(name, version, "package.tar",
                                   binary=True), version)
        pdir = self._package_dir(name, version)
        with open(os.path.join(pdir, "package.tar"), "rb") as fin:
            return fin.read(), version

    def metadata(self, name, version):
        if self.git_backed:
            if version not in self._git_versions(name):
                raise KeyError("unknown version %s" % version)
            return json.loads(
                self._git_show(name, version, "metadata.json"))
        with open(os.path.join(self._package_dir(name, version),
                               "metadata.json")) as fin:
            return json.load(fin)

    def index(self):
        out = []
        for name in sorted(os.listdir(self.root_dir)):
            if self.git_backed:
                versions = self.versions(name)
                if not versions:
                    continue
                if versions[-1] == self._worktree_version(name):
                    # worktree fast path: one file read, no git show
                    path = os.path.join(self.root_dir, name,
                                        "metadata.json")
                    with open(path) as fin:
                        out.append(json.load(fin))
                else:
                    out.append(self.metadata(name, versions[-1]))
                continue
            versions = self.versions(name)
            if versions:
                out.append(self.metadata(name, versions[-1]))
        return out

    # -- HTTP ---------------------------------------------------------------

    def _app(self, method, path, headers, body):
        parts = urlsplit(path)
        query = parse_qs(parts.query, keep_blank_values=True)

        def arg(name, default=_MissingArgument):
            if name in query:
                return query[name][-1]
            if default is _MissingArgument:
                raise _MissingArgument(name)
            return default

        route = (method, parts.path)
        try:
            if route == ("GET", "/service"):
                return self._service(arg)
            if route == ("GET", "/fetch"):
                return self._fetch(arg)
            if route == ("POST", "/upload"):
                return self._upload(arg, headers, body)
        except _MissingArgument as exc:
            return 400, None, {"error": "missing argument %s" % exc}
        return 404, None, {"error": "not found"}

    def _service(self, arg):
        query = arg("query", "list")
        if query == "list":
            return 200, None, {"packages": self.index()}
        if query == "details":
            name = arg("name")
            try:
                versions = self.versions(name)
            except ValueError:
                return 400, None, {"error": "illegal name"}
            if not versions:
                return 404, None, {"error": "unknown package"}
            return 200, None, {
                "name": name, "versions": versions,
                "metadata": self.metadata(name, versions[-1])}
        return 400, None, {"error": "unknown query"}

    def _fetch(self, arg):
        name = arg("name")
        version = arg("version", "latest")
        try:
            payload, version = self.load(name, version)
        except ValueError:
            return 400, None, b""
        except (KeyError, OSError):
            return 404, None, b""
        return 200, {"Content-Type": "application/octet-stream",
                     "X-Package-Version": version}, payload

    def _upload(self, arg, headers, body):
        if self.upload_token:
            auth = headers.get("Authorization", "")
            want = "Bearer %s" % self.upload_token
            if not hmac.compare_digest(auth, want):
                return 401, None, {"error": "upload token required"}
        name = arg("name")
        version = arg("version")
        meta_json = arg("metadata", "{}")
        try:
            self.store(name, version, body, json.loads(meta_json))
        except ValueError as exc:
            # "already published" and a malformed name both say why
            return 400, None, {"error": str(exc)}
        return 200, None, {"result": "ok"}

    def start_background(self):
        from veles_tpu_torch.http_util import BackgroundHTTPServer
        self._server_ = BackgroundHTTPServer(
            self._app, port=self.port, max_body=MAX_BODY, with_query=True)
        thread = self._server_.start()
        self.port = self._server_.port
        self.info("forge on http://127.0.0.1:%d/", self.port)
        return thread

    def stop(self):
        if self._server_ is not None:
            self._server_.stop()
            self._server_ = None
