"""Tune markers: declare which config/hyper values the GA may vary.

Counterpart of ``veles_tpu/genetics/config.py``.  Reference:
genetics/config.py:45-110 wrapped config leaves in ``Tune(value, min,
max)``; the optimizer collected them into a chromosome and wrote
candidate values back before each evaluation.
Here Tune works on any nested dict/list structure (including the layer
specs fed to StandardWorkflow) as well as the global Config tree.
"""

__all__ = ["Tune", "extract_tunes", "apply_values"]


class Tune(object):
    """A tunable leaf: default value + allowed [min, max] box."""

    def __init__(self, value, minimum, maximum):
        self.value = value
        self.min = minimum
        self.max = maximum

    def __repr__(self):
        return "Tune(%s, %s, %s)" % (self.value, self.min, self.max)


def _walk(obj, path, found):
    if isinstance(obj, Tune):
        found.append((path, obj))
    elif isinstance(obj, dict):
        for key, value in obj.items():
            _walk(value, path + (key,), found)
    elif isinstance(obj, (list, tuple)):
        for i, value in enumerate(obj):
            _walk(value, path + (i,), found)


def extract_tunes(spec):
    """Return [(path, Tune), ...] in deterministic order."""
    found = []
    _walk(spec, (), found)
    found.sort(key=lambda pair: str(pair[0]))
    return found


def apply_values(spec, tunes, values):
    """Deep-copy ``spec`` with each Tune leaf replaced by its candidate
    value (int-preserving when the Tune default was an int)."""
    import copy
    result = copy.deepcopy(spec)
    for (path, tune), value in zip(tunes, values):
        if isinstance(tune.value, int) and not isinstance(tune.value, bool):
            value = int(round(value))
        node = result
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return result
