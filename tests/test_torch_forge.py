"""The port's forge (veles_tpu_torch/forge/: the server on http.server,
the client, ``python -m veles_tpu_torch.forge``) against the JAX
package's (veles_tpu/forge/, on tornado).

- tests/test_forge.py's seven cases on the port: upload, list, details
  and fetch of a package the port exported; the fetched package run by
  the port's native bridge; the unknown package's 404; path traversal
  refused with 400; the git-backed store's round trip, out-of-order
  uploads and natural version sort;
- the upload token of tests/test_service_depth.py (401 without it or
  with a wrong one, nothing stored);
- the JAX client against the port's server and the port's client
  against the JAX server: the same listings, bytes, versions and
  headers;
- an upload announcing more than 1 GiB is refused with 400 before its
  body is read (tornado's ``max_buffer_size``), not left hanging;
- the command line's four verbs against a port server.
"""

import json
import os
import shutil
import subprocess
import sys
import urllib.error
import urllib.request

import numpy
import pytest

from veles_tpu_torch.forge import (ForgeServer, details, fetch,
                                   list_packages, upload)

from torch_services import train_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_git = pytest.mark.skipif(shutil.which("git") is None,
                               reason="git unavailable")


@pytest.fixture()
def forge(tmp_path):
    server = ForgeServer(str(tmp_path / "store"))
    server.start_background()
    yield server
    server.stop()


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pkg") / "m.veles.tar")
    train_mlp(epochs=1).package_export(path)
    return path


def _url(server):
    return "http://127.0.0.1:%d" % server.port


def test_forge_upload_list_fetch(forge, tmp_path, package):
    url = _url(forge)
    upload(url, "blobs-mlp", "1.0.0", package,
           metadata={"workflow": "StandardWorkflow"})
    upload(url, "blobs-mlp", "1.1.0", package)
    packages = list_packages(url)
    assert len(packages) == 1 and packages[0]["version"] == "1.1.0"
    assert details(url, "blobs-mlp")["versions"] == ["1.0.0", "1.1.0"]
    out = str(tmp_path / "fetched.tar")
    path, version = fetch(url, "blobs-mlp", out)
    assert version == "1.1.0"
    assert open(path, "rb").read() == open(package, "rb").read()


def test_forge_fetched_package_runs_natively(forge, tmp_path, package):
    from veles_tpu_torch import native
    url = _url(forge)
    upload(url, "mlp", "0.1", package)
    out, _ = fetch(url, "mlp", str(tmp_path / "f.tar"))
    probs = native.NativeWorkflow(out).run(
        numpy.random.RandomState(0).rand(4, 16))
    assert numpy.allclose(probs.sum(axis=1), 1.0, atol=1e-4)


def test_forge_unknown_package_404(forge, tmp_path):
    with pytest.raises(urllib.error.HTTPError) as err:
        fetch(_url(forge), "nope", str(tmp_path / "x.tar"))
    assert err.value.code == 404


def test_forge_rejects_path_traversal(forge, tmp_path):
    url = ("%s/upload?name=pkg&version=..%%2F..%%2Fevil" % _url(forge))
    req = urllib.request.Request(url, data=b"payload", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 400
    assert not (tmp_path / "evil").exists()
    assert not (tmp_path.parent / "evil").exists()
    with pytest.raises(ValueError):
        forge.store("../pkg", "1.0.0", b"x")
    with pytest.raises(ValueError):
        forge.store("pkg", "../../1.0.0", b"x")


@needs_git
def test_git_backed_forge_roundtrip(tmp_path):
    server = ForgeServer(str(tmp_path / "hub"), git_backed=True)
    server.start_background()
    base = _url(server)
    try:
        v1, v2 = b"PKG-v1" * 100, b"PKG-v2" * 100
        for version, payload in (("1.0.0", v1), ("1.1.0", v2)):
            req = urllib.request.Request(
                base + "/upload?name=demo&version=%s" % version,
                data=payload)
            assert json.loads(urllib.request.urlopen(req).read())[
                "result"] == "ok"
        req = urllib.request.Request(
            base + "/upload?name=demo&version=1.0.0", data=v1)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
        assert "already published" in json.loads(err.value.read())["error"]
        with urllib.request.urlopen(
                base + "/service?query=details&name=demo") as resp:
            info = json.loads(resp.read())
        assert info["versions"] == ["1.0.0", "1.1.0"]
        assert info["metadata"]["version"] == "1.1.0"
        with urllib.request.urlopen(
                base + "/fetch?name=demo&version=1.0.0") as resp:
            assert resp.read() == v1
        with urllib.request.urlopen(base + "/fetch?name=demo") as resp:
            assert resp.headers["X-Package-Version"] == "1.1.0"
            assert resp.read() == v2
        assert (tmp_path / "hub" / "demo" / ".git").is_dir()
    finally:
        server.stop()


@needs_git
def test_git_backed_forge_out_of_order_uploads(tmp_path):
    server = ForgeServer(str(tmp_path / "hub"), git_backed=True)
    v110, v101 = b"NEW" * 50, b"OLD-BACKFILL" * 50
    server.store("demo", "1.1.0", v110)
    server.store("demo", "1.0.1", v101)
    assert server.load("demo", "latest") == (v110, "1.1.0")
    assert server.index()[0]["version"] == "1.1.0"
    assert server.load("demo", "1.0.1") == (v101, "1.0.1")


@pytest.mark.parametrize("git_backed", [False, True], ids=["plain", "git"])
def test_forge_versions_sort_numerically(tmp_path, git_backed):
    if git_backed and shutil.which("git") is None:
        pytest.skip("git unavailable")
    hub = ForgeServer(str(tmp_path / "hub"), git_backed=git_backed)
    hub.store("p", "1.10.0", b"ten")
    hub.store("p", "1.9.0", b"nine")
    assert hub.versions("p") == ["1.9.0", "1.10.0"]
    assert hub.load("p", "latest") == (b"ten", "1.10.0")


def test_forge_upload_token_auth(tmp_path):
    server = ForgeServer(str(tmp_path / "store"), upload_token="tok123")
    server.start_background()
    url = _url(server)
    pkg = tmp_path / "p.tar"
    pkg.write_bytes(b"payload")
    try:
        for token in ("", "nope"):
            with pytest.raises(urllib.error.HTTPError) as err:
                upload(url, "pkg", "1.0.0", str(pkg), token=token)
            assert err.value.code == 401
        assert list_packages(url) == []
        upload(url, "pkg", "1.0.0", str(pkg), token="tok123")
        assert len(list_packages(url)) == 1
    finally:
        server.stop()


def test_body_past_the_limit_is_refused(forge):
    """An upload announcing more than 1 GiB is answered 400 at once,
    before its body is read (tornado's ``max_buffer_size``), and stores
    nothing."""
    import socket
    from veles_tpu_torch.forge.server import MAX_BODY
    with socket.create_connection(("127.0.0.1", forge.port),
                                  timeout=10) as sock:
        sock.sendall(("POST /upload?name=big&version=1 HTTP/1.1\r\n"
                      "Host: 127.0.0.1\r\nContent-Length: %d\r\n\r\n"
                      % (MAX_BODY + 1)).encode() + b"x" * 1024)
        head = sock.recv(4096).split(b"\r\n", 1)[0]
    assert head.startswith(b"HTTP/1.0 400") or head.startswith(
        b"HTTP/1.1 400"), head
    assert list_packages(_url(forge)) == []


def _write(tmp_path, data):
    path = tmp_path / "payload.tar"
    path.write_bytes(data)
    return str(path)


def _exchange(client, server_url, tmp_path, payload):
    """Upload two versions through ``client``, then list, details and
    fetch both; returns what came back."""
    pkg = _write(tmp_path, payload)
    client.upload(server_url, "x", "1.9.0", pkg, metadata={"k": 1})
    client.upload(server_url, "x", "1.10.0", pkg)
    out = {"list": client.list_packages(server_url),
           "details": client.details(server_url, "x")}
    for version in ("1.9.0", "latest"):
        path, got = client.fetch(server_url, "x",
                                 str(tmp_path / "fetched.tar"), version)
        with open(path, "rb") as fin:
            out[version] = (fin.read(), got)
    return out


def test_clients_and_servers_cross(tmp_path):
    """Each package's client on the other's server, and each on its
    own: the same answers and bytes all four ways."""
    from veles_tpu.forge import ForgeServer as JaxForgeServer
    from veles_tpu.forge import client as jax_client
    from veles_tpu_torch.forge import client as torch_client
    payload = bytes(range(256)) * 64
    servers = {"jax": JaxForgeServer(str(tmp_path / "jax")),
               "port": ForgeServer(str(tmp_path / "port"))}
    for server in servers.values():
        server.start_background()
    try:
        runs = {}
        for cname, client in (("jax", jax_client), ("port", torch_client)):
            for sname, server in servers.items():
                # each pairing gets a fresh package name's store
                sub = tmp_path / ("%s_on_%s" % (cname, sname))
                sub.mkdir()
                shutil.rmtree(server.root_dir)
                os.makedirs(server.root_dir)
                server._versions_cache.clear()
                runs[cname, sname] = _exchange(client, _url(server), sub,
                                               payload)
        first = runs["jax", "jax"]
        for key, run in runs.items():
            assert run == first, key
        assert first["latest"] == (payload, "1.10.0")
        assert first["details"]["versions"] == ["1.9.0", "1.10.0"]
        assert first["details"]["metadata"]["size"] == len(payload)
    finally:
        for server in servers.values():
            server.stop()


def test_forge_command_line(forge, tmp_path, package):
    env = dict(os.environ, PYTHONPATH=ROOT)
    url = _url(forge)

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch.forge"] + list(args),
            capture_output=True, text=True, timeout=120, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout

    assert cli("upload", url, "mlp", "2.0.0", package,
               "--metadata", '{"workflow": "StandardWorkflow"}') == \
        "uploaded mlp==2.0.0\n"
    size = os.path.getsize(package)
    assert cli("list", url) == "mlp==2.0.0  (%d bytes)\n" % size
    info = json.loads(cli("details", url, "mlp"))
    assert info["versions"] == ["2.0.0"]
    assert info["metadata"]["workflow"] == "StandardWorkflow"
    out = str(tmp_path / "cli.tar")
    assert cli("fetch", url, "mlp", out) == \
        "fetched mlp==2.0.0 -> %s\n" % out
    assert open(out, "rb").read() == open(package, "rb").read()
