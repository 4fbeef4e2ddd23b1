"""Forge client: upload / fetch / list / details.

Counterpart of ``veles_tpu/forge/client.py``, byte for byte the same
protocol: the same URLs, query strings, headers and bodies.  The
command line is ``python -m veles_tpu_torch.forge``; ``python -m
veles_tpu_torch.forge.client`` is the JAX client's shorter one (``list``,
``fetch -o``, ``upload``).
"""

import json
import os
import urllib.parse
import urllib.request

__all__ = ["upload", "fetch", "list_packages", "details", "main"]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read(), dict(resp.headers)


def list_packages(base_url):
    data, _ = _get(base_url.rstrip("/") + "/service?query=list")
    return json.loads(data)["packages"]


def details(base_url, name):
    data, _ = _get(base_url.rstrip("/") +
                   "/service?query=details&name=" +
                   urllib.parse.quote(name))
    return json.loads(data)


def fetch(base_url, name, destination, version="latest"):
    data, headers = _get(
        base_url.rstrip("/") + "/fetch?name=%s&version=%s" % (
            urllib.parse.quote(name), urllib.parse.quote(version)))
    with open(destination, "wb") as fout:
        fout.write(data)
    return destination, headers.get("X-Package-Version")


def upload(base_url, name, version, package_path, metadata=None,
           token=None):
    with open(package_path, "rb") as fin:
        payload = fin.read()
    query = urllib.parse.urlencode({
        "name": name, "version": version,
        "metadata": json.dumps(metadata or {})})
    headers = {"Content-Type": "application/octet-stream"}
    token = token if token is not None else os.environ.get(
        "VELES_FORGE_TOKEN")
    if token:
        headers["Authorization"] = "Bearer %s" % token
    req = urllib.request.Request(
        base_url.rstrip("/") + "/upload?" + query, data=payload,
        headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.forge.client")
    sub = parser.add_subparsers(dest="command", required=True)
    p_list = sub.add_parser("list")
    p_list.add_argument("url")
    p_fetch = sub.add_parser("fetch")
    p_fetch.add_argument("url")
    p_fetch.add_argument("name")
    p_fetch.add_argument("-o", "--output", default=None)
    p_fetch.add_argument("--version", default="latest")
    p_up = sub.add_parser("upload")
    p_up.add_argument("url")
    p_up.add_argument("name")
    p_up.add_argument("version")
    p_up.add_argument("package")
    args = parser.parse_args(argv)
    if args.command == "list":
        for meta in list_packages(args.url):
            print("%s==%s (%d bytes)" % (meta["name"], meta["version"],
                                         meta["size"]))
    elif args.command == "fetch":
        out = args.output or (args.name + ".tar")
        path, version = fetch(args.url, args.name, out, args.version)
        print("%s==%s -> %s" % (args.name, version, path))
    elif args.command == "upload":
        upload(args.url, args.name, args.version, args.package)
        print("uploaded %s==%s" % (args.name, args.version))


if __name__ == "__main__":
    main()
