"""Graphics client: subscribes to the PUB socket and renders plots.

Counterpart of ``veles_tpu/graphics_client.py``: renders with
matplotlib's Agg backend, one PNG per plotter class (updated in place).
Run as::

    python -m veles_tpu_torch.graphics_client --endpoint tcp://... \\
        --output DIR [--limit N]

Where matplotlib is not installed, :func:`render_plot` raises
``ImportError``, as the JAX package's does.
"""

import argparse
import os

from veles_tpu_torch import plotter as plotter_module

__all__ = ["render_plot", "main"]


def render_plot(plot, output_dir):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(figsize=(6, 4), dpi=96)
    plot.render(axes)
    path = os.path.join(output_dir, "%s.png" % type(plot).__name__)
    fig.savefig(path)
    plt.close(fig)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.graphics_client")
    parser.add_argument("--endpoint", required=True)
    parser.add_argument("--output", default=".")
    parser.add_argument("--limit", type=int, default=0,
                        help="exit after N plots (0 = run forever)")
    args = parser.parse_args(argv)

    import zmq
    context = zmq.Context.instance()
    socket = context.socket(zmq.SUB)
    socket.connect(args.endpoint)
    socket.setsockopt(zmq.SUBSCRIBE, b"")
    os.makedirs(args.output, exist_ok=True)

    count = 0
    try:
        while True:
            plot = plotter_module.loads(socket.recv())
            render_plot(plot, args.output)
            count += 1
            if args.limit and count >= args.limit:
                break
    finally:
        socket.close(0)


if __name__ == "__main__":
    main()
