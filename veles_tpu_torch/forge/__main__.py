"""Forge command line: ``python -m veles_tpu_torch.forge
list|details|fetch|upload <hub-url> ...``, the JAX package's verbs,
arguments and printed lines.
"""

import argparse
import json
import sys

from veles_tpu_torch.forge import client


def main(argv=None):
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.forge")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list hub packages")
    p.add_argument("url")

    p = sub.add_parser("details", help="package metadata + versions")
    p.add_argument("url")
    p.add_argument("name")

    p = sub.add_parser("fetch", help="download a package")
    p.add_argument("url")
    p.add_argument("name")
    p.add_argument("destination")
    p.add_argument("--version", default="latest")

    p = sub.add_parser("upload", help="publish a package")
    p.add_argument("url")
    p.add_argument("name")
    p.add_argument("version")
    p.add_argument("package")
    p.add_argument("--metadata", default="{}",
                   help="JSON metadata string")
    p.add_argument("--token", default=None,
                   help="bearer upload token ($VELES_FORGE_TOKEN)")

    args = parser.parse_args(argv)
    if args.cmd == "list":
        for pkg in client.list_packages(args.url):
            print("%s==%s  (%s bytes)" % (
                pkg.get("name"), pkg.get("version"), pkg.get("size")))
    elif args.cmd == "details":
        print(json.dumps(client.details(args.url, args.name),
                         indent=1, sort_keys=True))
    elif args.cmd == "fetch":
        _, version = client.fetch(args.url, args.name,
                                  args.destination,
                                  version=args.version)
        print("fetched %s==%s -> %s" % (args.name, version,
                                        args.destination))
    elif args.cmd == "upload":
        client.upload(args.url, args.name, args.version, args.package,
                      metadata=json.loads(args.metadata),
                      token=args.token)
        print("uploaded %s==%s" % (args.name, args.version))
    return 0


if __name__ == "__main__":
    sys.exit(main())
