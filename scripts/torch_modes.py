"""Raw and graphed runs of a profile script side by side.

``side_by_side(script, argv)`` runs ``script --mode raw`` and then
``script --mode graph`` (each with ``argv``), each in its own process so
that each traces in a ``torch.profiler`` session of its own, and
returns ``{"raw": ..., "graph": ...}``: the JSON object each child
printed as its last line.  ``raw`` runs the uncaptured steps and
forwards (``build_train_step(donate=False)``, ``AOTEngine``'s forward
called directly, the trainer's eager route); ``graph`` the captured
ones the port runs by default.  A child that fails raises.
"""

import json
import subprocess
import sys

MODES = ("raw", "graph")


def side_by_side(script, argv):
    out = {}
    for mode in MODES:
        proc = subprocess.run([sys.executable, script, "--mode", mode] +
                              list(argv), stdout=subprocess.PIPE,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s --mode %s exited with %d" % (
                script, mode, proc.returncode))
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


def report(result, mode, out_path):
    """Print ``result`` (indented for a reader; one line for a parent
    process, ``mode`` set) and write it to ``out_path`` when given."""
    import os
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fout:
            json.dump(result, fout, indent=1)
    print(json.dumps(result) if mode else json.dumps(result, indent=1))
