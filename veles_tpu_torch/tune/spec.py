"""Per-kernel-family search spaces for the schedule autotuner.

Counterpart of ``veles_tpu/tune/spec.py``.  The JAX families tune Pallas
tiles; most of those tiles do not exist in the port, whose kernels pick
their launch parameters by rule (``plan_matmul``, ``plan_int8``,
``plan_wgrad``, ``plan_pool_bwd``, the attention forward's persistent
grid).  A family's genes are what its rule chooses, within what the
kernel accepts; the rule stays the static default:

- ``matmul`` (kernel 2, ``ops/matmul.py``): ``bk``, the K-tile of the
  fold (a multiple of ``STEP`` = 64, at most ``ceil_mult(K, 128)``) and
  ``splits``, the split-K count (1 to the K-tiles).  The fold's
  association moves; results are bit-equal on representable operands;
- ``matmul_int8`` (kernel 3): ``config``, one of ``INT8_TILES``, and
  ``splits`` (1 to the 64-byte K-steps).  Integer sums: no effect;
- ``conv_vjp`` (kernel 12, the wgrad): ``tile``, (128, 64) or (128, 128)
  where Co % 128 == 0 at level 0 (the SIMT design's one tile at levels 1
  and 2), and ``chunk``, the rows of P a split gets (a multiple of
  ``STAGE``).  The splits' association moves;
- ``attention`` (kernel 6, the level-0 forward): ``grid``, the
  persistent blocks of a launch (0: as many as the card holds at once,
  the static rule).  Each (batch-head, q tile) item is computed by one
  block: no effect.  The backward kernels 7 and 8 launch one block an
  item and have no free launch parameter, and the level-1/2 forward is
  not persistent: those calls are untunable;
- ``pool_bwd`` (kernel 13): ``design``, ``overlap`` (legal everywhere)
  or ``cells`` (where each input lies in at most one window), and
  ``lanes_x``, a power of two up to 32.  Routing is exact: no effect.

Each family owns the search space as Tune markers, the quantization of
raw genes, ``validate`` (structure, and with a spec the bounds of the
call's shape: what the consult checks, host-only), ``feasible`` (that
and the card's limits, checked before any launch: the 65,535 grid
bound of the splits, the SMs bounding the persistent grid, a split
workspace cap), the seeds, the static default and the runner builder.  The
``*_spec`` builders at the bottom are the ONE definition of each key:
the kernels' consults and the tuner both call them.  The key's shape is
the raw dims the plan depends on, never padded to another chip's quanta;
the key carries the family's port kernel version
(``ops.common.PORT_KERNEL_VERSIONS``).

A schedule changes scheduling only, never what is computed: the
precision level and the dtype are key coordinates, not genes.
"""

import logging

import numpy

from veles_tpu_torch.genetics.config import Tune

__all__ = ["FAMILIES", "family_for", "matmul_spec", "matmul_int8_spec",
           "conv_vjp_spec", "pool_bwd_spec", "attention_spec",
           "valid_schedule", "current_kernel_version", "card_limits",
           "WORKSPACE_CAP_BYTES", "MAX_GRID"]

logger = logging.getLogger("veles_tpu_torch.tune")

#: the most bytes of split workspace a candidate may ask for
WORKSPACE_CAP_BYTES = 2 ** 30
#: CUDA's bound on a grid's y and z extent, where the kernels put splits
MAX_GRID = 65535
#: the attention forward's q rows an item (csrc/attention.cuh's B)
_ATTENTION_ROWS = 64
#: the persistent grid's largest candidate, in blocks an SM
_ATTENTION_GRID_PER_SM = 8

_warned = set()


def _warn_once(key, message, *args):
    if key not in _warned:
        _warned.add(key)
        logger.warning(message, *args)


def _ceil_mult(value, mult):
    rem = value % mult
    return value if rem == 0 else value + mult - rem


def _cdiv(a, b):
    return -(-int(a) // int(b))


def _quant(value, mult, lo, hi):
    """Round a raw gene to the nearest multiple of ``mult`` inside
    [lo, hi]: clamped duplicates collapse onto one schedule, which the
    tuner's fitness memo then serves for free."""
    q = int(round(float(value) / mult)) * mult
    return max(lo, min(hi, q))


def _clamp(value, lo, hi):
    return max(lo, min(hi, int(round(float(value)))))


def _is_int(value):
    return isinstance(value, int) and not isinstance(value, bool)


def card_limits(device=None):
    """The card's limits a candidate is checked against before launch,
    read from ``torch.cuda.get_device_properties`` for a CUDA device:
    its SMs (the rules' splits and the persistent grid's bound).  A CPU
    device (the tests) takes an H100 SXM's.  No gene changes a block's
    shared memory (each tile a gene picks is one of the kernel's built
    designs), and splits stay under ``MAX_GRID``."""
    import torch
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return {"sms": int(props.multi_processor_count)}
    return {"sms": 132}


def _torch_dtype(name):
    import torch
    return getattr(torch, str(name))


def _seeded(shape, seed, scale, dtype, device, low=None, high=None):
    """Seeded operands on ``device`` (numpy RandomState, as the JAX
    runners draw theirs)."""
    import torch
    rng = numpy.random.RandomState(seed)
    if low is not None:
        host = rng.randint(low, high, shape)
    else:
        host = rng.randn(*shape) * scale
    return torch.as_tensor(host).to(dtype).to(device)


#: the last runner's operands: (key, tensors).  A generation's runners of
#: one spec share them, so a VGG16 layer's gigabyte of activations is made
#: once, not once a candidate
_operands = [None, None]


def _operands_for(key, make):
    if _operands[0] != key:
        _operands[0] = _operands[1] = None
        _operands[1] = make()
        _operands[0] = key
    return _operands[1]


def _runner(call, device):
    """(warm, run) around ``call()``: ``run(n)`` enqueues n calls (the
    timing waits on the card); ``warm()`` builds the kernels and runs
    one call to its end."""
    import torch

    def run(count):
        out = None
        for _ in range(count):
            out = call()
        return out

    def warm():
        run(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    return warm, run


class MatmulFamily(object):
    """``bk`` and ``splits`` of csrc/matmul.cu (kernel 2)."""

    name = "matmul"

    @staticmethod
    def _dims(spec):
        m, k, n = (int(v) for v in spec["shape"])
        return m, k, n, _ceil_mult(k, 128)

    def space(self, spec):
        from veles_tpu_torch.ops.matmul import STEP
        m, k, n, kmax = self._dims(spec)
        if k < STEP or not (m and n):
            return None   # the general design: one K-tile walk, no split
        return {"bk": Tune(min(512, kmax), STEP, kmax),
                "splits": Tune(1, 1, min(_cdiv(k, STEP), MAX_GRID))}

    def quantize(self, spec, genes):
        from veles_tpu_torch.ops.matmul import STEP
        _m, k, _n, kmax = self._dims(spec)
        bk = _quant(genes["bk"], STEP, STEP, kmax)
        return {"bk": bk, "splits": _clamp(genes["splits"], 1,
                                           _cdiv(k, bk))}

    def _workspace(self, spec, schedule):
        m, _k, n, _ = self._dims(spec)
        splits = schedule["splits"]
        return (splits * (2 if spec["precision_level"] else 1) * m * n * 4
                if splits > 1 else 0)

    def footprint(self, spec, schedule):
        """Bytes the call moves: operands, output and split workspace."""
        m, k, n, _ = self._dims(spec)
        return 4 * (m * k + k * n + m * n) + self._workspace(spec,
                                                             schedule)

    def validate(self, schedule, spec=None):
        from veles_tpu_torch.ops.matmul import STEP
        bk, splits = schedule.get("bk"), schedule.get("splits")
        if not (_is_int(bk) and _is_int(splits) and bk > 0
                and bk % STEP == 0 and splits >= 1
                and set(schedule) == {"bk", "splits"}):
            return None
        if spec is not None:
            _m, k, _n, kmax = self._dims(spec)
            if k < STEP or bk > kmax or splits > _cdiv(k, bk) or \
                    splits > MAX_GRID:
                return None
        return {"bk": bk, "splits": splits}

    def feasible(self, spec, schedule, limits=None):
        return (self.validate(schedule, spec) is not None and
                self._workspace(spec, schedule) <= WORKSPACE_CAP_BYTES)

    def default(self, spec, limits=None):
        from veles_tpu_torch.ops.matmul import plan_matmul
        m, k, n, kmax = self._dims(spec)
        bk = min(512, kmax)
        plan = plan_matmul(m, k, n, bk, spec["precision_level"],
                           _torch_dtype(spec["dtype"]), (k, 1), (n, 1),
                           0, 0, (limits or card_limits())["sms"])
        return {"bk": bk, "splits": plan["splits"]}

    def seeds(self, spec, limits=None):
        _m, k, _n, kmax = self._dims(spec)
        rule = self.default(spec, limits)
        out = [rule]
        for bk in (256, 1024, 128, 512, 2048, 64):
            bk = min(bk, kmax)
            for splits in (rule["splits"], 1, 2 * rule["splits"]):
                out.append({"bk": bk, "splits": max(1, min(
                    splits, _cdiv(k, bk)))})
        return _distinct(out)

    def genes_of(self, schedule):
        return {"bk": schedule["bk"], "splits": schedule["splits"]}

    def build_runner(self, spec, schedule, device="cpu"):
        from veles_tpu_torch.ops.matmul import matmul
        m, k, n, _ = self._dims(spec)
        dtype = _torch_dtype(spec["dtype"])
        a, b = _operands_for(
            ("matmul", m, k, n, spec["dtype"], str(device)),
            lambda: (_seeded((m, k), 13, 0.01, dtype, device),
                     _seeded((k, n), 14, 0.01, dtype, device)))
        level = spec["precision_level"]
        return _runner(lambda: matmul(a, b, precision_level=level,
                                      schedule=schedule), device)


class MatmulInt8Family(object):
    """``config`` (the tile) and ``splits`` of csrc/matmul_int8.cu
    (kernel 3)."""

    name = "matmul_int8"

    @staticmethod
    def _steps(spec):
        from veles_tpu_torch.ops.matmul_int8 import INT8_STEP, K_ALIGN
        return _cdiv(_ceil_mult(int(spec["shape"][1]), K_ALIGN), INT8_STEP)

    def space(self, spec):
        m, k, n = (int(v) for v in spec["shape"])
        if not (m and k and n):
            return None
        from veles_tpu_torch.ops.matmul_int8 import INT8_TILES
        return {"config": Tune(0, 0, len(INT8_TILES) - 1),
                "splits": Tune(1, 1, min(self._steps(spec), MAX_GRID))}

    def quantize(self, spec, genes):
        from veles_tpu_torch.ops.matmul_int8 import INT8_TILES
        return {"config": _clamp(genes["config"], 0, len(INT8_TILES) - 1),
                "splits": _clamp(genes["splits"], 1,
                                 min(self._steps(spec), MAX_GRID))}

    def footprint(self, spec, schedule):
        m, k, n = (int(v) for v in spec["shape"])
        splits = schedule["splits"]
        return m * k + k * n + 4 * m * n + (4 * splits * m * n
                                            if splits > 1 else 0)

    def validate(self, schedule, spec=None):
        from veles_tpu_torch.ops.matmul_int8 import INT8_TILES
        config, splits = schedule.get("config"), schedule.get("splits")
        if not (_is_int(config) and _is_int(splits)
                and 0 <= config < len(INT8_TILES) and splits >= 1
                and set(schedule) == {"config", "splits"}):
            return None
        if spec is not None and (splits > self._steps(spec) or
                                 splits > MAX_GRID):
            return None
        return {"config": config, "splits": splits}

    def feasible(self, spec, schedule, limits=None):
        m, _k, n = (int(v) for v in spec["shape"])
        return (self.validate(schedule, spec) is not None and
                (schedule["splits"] == 1 or
                 4 * schedule["splits"] * m * n <= WORKSPACE_CAP_BYTES))

    def default(self, spec, limits=None):
        from veles_tpu_torch.ops.matmul_int8 import plan_int8
        m, k, n = (int(v) for v in spec["shape"])
        plan = plan_int8(m, k, n, (limits or card_limits())["sms"])
        return {"config": plan["config"], "splits": plan["splits"]}

    def seeds(self, spec, limits=None):
        from veles_tpu_torch.ops.matmul_int8 import INT8_TILES
        rule = self.default(spec, limits)
        steps = self._steps(spec)
        out = [rule]
        for config in range(len(INT8_TILES)):
            for splits in (rule["splits"], 1, max(1, rule["splits"] // 2),
                           2 * rule["splits"]):
                out.append({"config": config,
                            "splits": max(1, min(splits, steps))})
        return _distinct(out)

    def genes_of(self, schedule):
        return {"config": schedule["config"],
                "splits": schedule["splits"]}

    def build_runner(self, spec, schedule, device="cpu"):
        import torch

        from veles_tpu_torch.ops.matmul_int8 import (kmajor_weight,
                                                     matmul_int8_kmajor)
        m, k, n = (int(v) for v in spec["shape"])

        def make():
            a = _seeded((m, k), 17, 0, torch.int8, device, -127, 128)
            b = _seeded((k, n), 18, 0, torch.int8, device, -127, 128)
            scale = torch.as_tensor(
                numpy.random.RandomState(19).rand(n) * 1e-3 + 1e-4,
                dtype=torch.float32).to(device)
            return a, kmajor_weight(b).contiguous(), scale
        a, w_t, scale = _operands_for(("matmul_int8", m, k, n,
                                       str(device)), make)
        return _runner(lambda: matmul_int8_kmajor(a, w_t, scale,
                                                  schedule=schedule),
                       device)


class ConvVjpFamily(object):
    """``tile`` and ``chunk`` of csrc/conv_wgrad.cu (kernel 12)."""

    name = "conv_vjp"

    @staticmethod
    def _tiles(spec):
        """The tiles the kernel takes at this spec's level and width."""
        from veles_tpu_torch.ops.conv_vjp import SIMT_TILE
        if spec["precision_level"] == 0 and spec["dtype"] == "float32":
            co = int(spec["shape"][3])
            return [(128, 64)] + ([(128, 128)] if co % 128 == 0 else [])
        return [tuple(SIMT_TILE)]

    @staticmethod
    def _chunks(spec):
        """(least, most) chunk: the least keeps the splits under the
        grid bound and the workspace cap."""
        from veles_tpu_torch.ops.conv_vjp import STAGE
        taps, p, ci, co = (int(v) for v in spec["shape"])
        per_split = 4 * taps * ci * co
        splits = min(MAX_GRID, max(1, WORKSPACE_CAP_BYTES // per_split))
        return (_ceil_mult(_cdiv(p, splits), STAGE),
                _ceil_mult(p, STAGE))

    def space(self, spec):
        taps, p, ci, co = (int(v) for v in spec["shape"])
        if not (p and ci and co and taps):
            return None
        least, most = self._chunks(spec)
        return {"tile": Tune(0, 0, len(self._tiles(spec)) - 1),
                "chunk": Tune(min(max(least, 512), most), least, most)}

    def quantize(self, spec, genes):
        from veles_tpu_torch.ops.conv_vjp import STAGE
        tiles = self._tiles(spec)
        least, most = self._chunks(spec)
        return {"tile": list(tiles[_clamp(genes["tile"], 0,
                                          len(tiles) - 1)]),
                "chunk": _quant(genes["chunk"], STAGE, least, most)}

    def footprint(self, spec, schedule):
        taps, p, ci, co = (int(v) for v in spec["shape"])
        splits = _cdiv(p, schedule["chunk"])
        return 4 * (p * ci + 2 * p * co + splits * taps * ci * co)

    def validate(self, schedule, spec=None):
        from veles_tpu_torch.ops.conv_vjp import SIMT_TILE, STAGE, \
            TC_RESIDENT
        tile, chunk = schedule.get("tile"), schedule.get("chunk")
        if not (isinstance(tile, (list, tuple)) and len(tile) == 2
                and all(_is_int(t) for t in tile) and _is_int(chunk)
                and chunk > 0 and chunk % STAGE == 0
                and set(schedule) == {"tile", "chunk"}):
            return None
        tile = (int(tile[0]), int(tile[1]))
        if tile not in TC_RESIDENT and tile != tuple(SIMT_TILE):
            return None
        if spec is not None:
            p = int(spec["shape"][1])
            least, most = self._chunks(spec)
            if tile not in self._tiles(spec) or chunk > most or \
                    _cdiv(p, chunk) > MAX_GRID:
                return None
        return {"tile": list(tile), "chunk": chunk}

    def feasible(self, spec, schedule, limits=None):
        if self.validate(schedule, spec) is None:
            return False
        least, _most = self._chunks(spec)
        return schedule["chunk"] >= least

    def default(self, spec, limits=None):
        from veles_tpu_torch.ops.conv_vjp import plan_wgrad
        raw = spec["raw"]
        n = raw["x_shape"][0]
        oh, ow = raw["y_hw"]
        _path, tile, _splits, chunk = plan_wgrad(
            (n, oh, ow, raw["x_shape"][3]), raw["cout"],
            (raw["ky"], raw["kx"]), spec["precision_level"],
            _torch_dtype(spec["dtype"]), (limits or card_limits())["sms"])
        return {"tile": list(tile), "chunk": chunk}

    def seeds(self, spec, limits=None):
        from veles_tpu_torch.ops.conv_vjp import STAGE
        rule = self.default(spec, limits)
        least, most = self._chunks(spec)
        out = [rule]
        for tile in self._tiles(spec):
            for scale in (1, 2, 0.5, 4, 0.25):
                chunk = _quant(rule["chunk"] * scale, STAGE, least, most)
                out.append({"tile": list(tile), "chunk": chunk})
        return _distinct(out)

    def genes_of(self, schedule):
        # the index into _tiles(spec): (128, 128) is the second level-0
        # tile; (128, 64) and the SIMT tile are each the first
        return {"tile": 1 if tuple(schedule["tile"]) == (128, 128) else 0,
                "chunk": schedule["chunk"]}

    def build_runner(self, spec, schedule, device="cpu"):
        from veles_tpu_torch.ops.conv_vjp import conv_wgrad
        raw = spec["raw"]
        n, h, w_sp, ci = raw["x_shape"]
        oh, ow = raw["y_hw"]
        cout = raw["cout"]
        dtype = _torch_dtype(spec["dtype"])
        x, y, dy = _operands_for(
            ("conv_vjp", tuple(raw["x_shape"]), oh, ow, cout,
             spec["dtype"], str(device)),
            lambda: (_seeded((n, h, w_sp, ci), 7, 0.1, dtype, device),
                     _seeded((n, oh, ow, cout), 8, 0.1, dtype, device),
                     _seeded((n, oh, ow, cout), 9, 0.1, dtype, device)))
        return _runner(lambda: conv_wgrad(
            x, y, dy, activation=raw["activation"],
            ksize=(raw["ky"], raw["kx"]), padding=tuple(raw["padding"]),
            sliding=tuple(raw["sliding"]),
            precision_level=spec["precision_level"],
            schedule=schedule), device)


class AttentionFamily(object):
    """``grid``, the persistent blocks of the level-0 flash forward
    (kernel 6, csrc/attention_fwd.cu)."""

    name = "attention"

    @staticmethod
    def _items(spec):
        b, t, _dh = (int(v) for v in spec["shape"])
        return b * _cdiv(t, _ATTENTION_ROWS)

    def _most(self, spec, limits=None):
        sms = (limits or card_limits())["sms"]
        return max(1, min(self._items(spec),
                          _ATTENTION_GRID_PER_SM * sms))

    def space(self, spec):
        if spec["precision_level"] != 0 or not self._items(spec):
            return None   # the SIMT forward launches one block an item
        return {"grid": Tune(1, 1, self._most(spec))}

    def quantize(self, spec, genes):
        return {"grid": _clamp(genes["grid"], 1, self._most(spec))}

    def footprint(self, spec, schedule):
        b, t, dh = (int(v) for v in spec["shape"])
        return 4 * (4 * b * t * dh + b * t)

    def validate(self, schedule, spec=None):
        grid = schedule.get("grid")
        if not (_is_int(grid) and grid >= 0 and set(schedule) == {"grid"}):
            return None
        if spec is not None and (spec["precision_level"] != 0 or
                                 grid > self._items(spec)):
            return None
        return {"grid": grid}

    def feasible(self, spec, schedule, limits=None):
        return (self.validate(schedule, spec) is not None and
                1 <= schedule["grid"] <= self._most(spec, limits))

    def default(self, spec, limits=None):
        return {"grid": 0}

    def seeds(self, spec, limits=None):
        sms = (limits or card_limits())["sms"]
        most = self._most(spec, limits)
        return _distinct([{"grid": min(most, max(1, g))} for g in (
            sms, 2 * sms, sms // 2, self._items(spec), 3 * sms,
            sms // 4, 4 * sms, 1)])

    def genes_of(self, schedule):
        return {"grid": schedule["grid"]}

    def build_runner(self, spec, schedule, device="cpu"):
        import math

        from veles_tpu_torch.ops.attention import attention_fwd
        b, t, dh = (int(v) for v in spec["shape"])
        dtype = _torch_dtype(spec["dtype"])
        q, k, v = _operands_for(
            ("attention", b, t, dh, spec["dtype"], str(device)),
            lambda: tuple(_seeded((b, t, dh), seed, 0.1, dtype, device)
                          for seed in (23, 24, 25)))
        scale = 1.0 / math.sqrt(dh)
        return _runner(lambda: attention_fwd(
            q, k, v, scale, precision_level=spec["precision_level"],
            schedule=schedule), device)


class PoolBwdFamily(object):
    """``design`` and ``lanes_x`` of csrc/pool_bwd.cu (kernel 13)."""

    name = "pool_bwd"

    @staticmethod
    def _designs(spec):
        ky, kx, sy, sx = (int(v) for v in spec["shape"][6:10])
        return ["cells", "overlap"] if kx <= sx and ky <= sy \
            else ["overlap"]

    def space(self, spec):
        if not int(spec["shape"][3]):
            return None
        return {"design": Tune(0, 0, len(self._designs(spec)) - 1),
                "lanes_log2": Tune(5, 0, 5)}

    def quantize(self, spec, genes):
        designs = self._designs(spec)
        return {"design": designs[_clamp(genes["design"], 0,
                                         len(designs) - 1)],
                "lanes_x": 2 ** _clamp(genes["lanes_log2"], 0, 5)}

    def footprint(self, spec, schedule):
        n, h, w_sp, c, oh, ow = (int(v) for v in spec["shape"][:6])
        return 4 * (2 * n * h * w_sp * c + 2 * n * oh * ow * c)

    def validate(self, schedule, spec=None):
        from veles_tpu_torch.ops.pool_bwd import PATHS
        design, lanes_x = schedule.get("design"), schedule.get("lanes_x")
        if not (design in PATHS and _is_int(lanes_x) and 1 <= lanes_x
                <= 32 and lanes_x & (lanes_x - 1) == 0
                and set(schedule) == {"design", "lanes_x"}):
            return None
        if spec is not None and (
                design not in self._designs(spec) or
                _cdiv(int(spec["shape"][3]), lanes_x) > MAX_GRID):
            return None
        return {"design": design, "lanes_x": lanes_x}

    def feasible(self, spec, schedule, limits=None):
        return self.validate(schedule, spec) is not None

    def default(self, spec, limits=None):
        from veles_tpu_torch.ops.pool_bwd import plan_pool_bwd
        ky, kx, sy, sx = (int(v) for v in spec["shape"][6:10])
        plan = plan_pool_bwd((ky, kx), (sx, sy), int(spec["shape"][3]))
        return {"design": plan["design"], "lanes_x": plan["lanes_x"]}

    def seeds(self, spec, limits=None):
        out = [self.default(spec, limits)]
        for design in self._designs(spec):
            for lanes_x in (32, 16, 8, 4, 2, 1):
                out.append({"design": design, "lanes_x": lanes_x})
        return _distinct(out)

    def genes_of(self, schedule):
        return {"design": 0 if schedule["design"] == "cells" else 1,
                "lanes_log2": int(schedule["lanes_x"]).bit_length() - 1}

    def build_runner(self, spec, schedule, device="cpu"):
        import torch

        from veles_tpu_torch.models.pooling import _pool
        from veles_tpu_torch.ops.pool_bwd import max_pool_bwd
        raw = spec["raw"]
        n, h, w_sp, c = raw["x_shape"]
        window, sliding = tuple(raw["window"]), tuple(raw["sliding"])
        dtype = _torch_dtype(spec["dtype"])

        def make():
            x = _seeded((n, h, w_sp, c), 5, 1.0, dtype, device)
            y = _pool(x, window, sliding, float("-inf"),
                      torch.nn.functional.max_pool2d).contiguous()
            dy = _seeded(tuple(y.shape), 6, 1.0, dtype, device)
            return x, y, dy
        x, y, dy = _operands_for(("pool_bwd", tuple(raw["x_shape"]),
                                  window, sliding, spec["dtype"],
                                  str(device)), make)
        return _runner(lambda: max_pool_bwd(
            x, y, dy, window=window, sliding=sliding, schedule=schedule),
            device)


def _distinct(schedules):
    out, seen = [], set()
    for schedule in schedules:
        key = repr(sorted(schedule.items()))
        if key not in seen:
            seen.add(key)
            out.append(schedule)
    return out


FAMILIES = {
    "matmul": MatmulFamily(),
    "matmul_int8": MatmulInt8Family(),
    "conv_vjp": ConvVjpFamily(),
    "pool_bwd": PoolBwdFamily(),
    "attention": AttentionFamily(),
}


def family_for(op):
    family = FAMILIES.get(op)
    if family is None:
        raise KeyError("unknown kernel family %r (have %s)" %
                       (op, sorted(FAMILIES)))
    return family


def current_kernel_version(op):
    """The family's port kernel version (the value its ``*_spec`` builder
    puts in ``extra``), or None for an unknown op."""
    from veles_tpu_torch.ops.common import PORT_KERNEL_VERSIONS
    return PORT_KERNEL_VERSIONS.get(op)


def valid_schedule(op, schedule, spec=None):
    """The family's normalized schedule, or None (with ONE warning) for
    anything malformed, or, given the call's ``spec``, out of its
    bounds: a stale or corrupt entry serves the static plan, never
    stops a kernel.  Host-only (the consult's check)."""
    family = FAMILIES.get(op)
    if family is None or not isinstance(schedule, dict):
        normalized = None
    else:
        normalized = family.validate(schedule, spec)
    if normalized is None:
        _warn_once(
            ("invalid", op, str(schedule),
             None if spec is None else str(spec.get("shape"))),
            "ignoring malformed tuned schedule for %s: %r (the kernel's "
            "static plan serves this shape)", op, schedule)
    return normalized


# -- cache-key spec builders (ONE definition per family) ---------------------


def _extra(op):
    return {"kernel_version": current_kernel_version(op)}


def matmul_spec(m, k, n, dtype, precision_level):
    """The matmul consult/tune spec: the raw (M, K, N), which the plan's
    design and split depend on."""
    return {
        "op": "matmul",
        "shape": [int(m), int(k), int(n)],
        "dtype": str(dtype).replace("torch.", ""),
        "precision_level": int(precision_level),
        "extra": _extra("matmul"),
        "raw": {"mkn": [int(m), int(k), int(n)]},
    }


def matmul_int8_spec(m, k, n):
    """The int8 matmul consult/tune spec: the raw (M, K, N); dtype
    ``int8``, level 0 (integer sums have no ladder)."""
    return {
        "op": "matmul_int8",
        "shape": [int(m), int(k), int(n)],
        "dtype": "int8",
        "precision_level": 0,
        "extra": _extra("matmul_int8"),
        "raw": {"mkn": [int(m), int(k), int(n)]},
    }


def conv_vjp_spec(x_shape, ky, kx, cout, y_hw, dtype, precision_level,
                  padding=(0, 0, 0, 0), sliding=(1, 1),
                  activation="linear"):
    """The wgrad consult/tune spec: shape (taps, P, Ci, Co), the
    contraction the plan cuts; the layer's geometry rides ``raw``."""
    n, _h, _w, ci = [int(s) for s in x_shape]
    oh, ow = [int(s) for s in y_hw]
    return {
        "op": "conv_vjp",
        "shape": [int(ky) * int(kx), n * oh * ow, ci, int(cout)],
        "dtype": str(dtype).replace("torch.", ""),
        "precision_level": int(precision_level),
        "extra": _extra("conv_vjp"),
        "raw": {"x_shape": [int(s) for s in x_shape],
                "y_hw": [oh, ow], "ky": int(ky), "kx": int(kx),
                "cout": int(cout),
                "padding": [int(p_) for p_ in padding],
                "sliding": [int(s) for s in sliding],
                "activation": str(activation)},
    }


def attention_spec(b, t, dh, dtype, precision_level):
    """The flash-attention consult/tune spec: the raw (B, T, dh), B the
    batch times the heads."""
    return {
        "op": "attention",
        "shape": [int(b), int(t), int(dh)],
        "dtype": str(dtype).replace("torch.", ""),
        "precision_level": int(precision_level),
        "extra": _extra("attention"),
        "raw": {"btd": [int(b), int(t), int(dh)]},
    }


def pool_bwd_spec(x_shape, out_hw, window, sliding, dtype):
    """The pool-backward consult/tune spec: every raw dim rides the key
    (the JAX key's layout)."""
    n, h, w_sp, c = [int(s) for s in x_shape]
    oh, ow = [int(s) for s in out_hw]
    ky, kx = [int(s) for s in window]
    sx, sy = [int(s) for s in sliding]
    return {
        "op": "pool_bwd",
        "shape": [n, h, w_sp, c, oh, ow, ky, kx, sy, sx],
        "dtype": str(dtype).replace("torch.", ""),
        "precision_level": 0,  # pooling has no precision ladder
        "extra": _extra("pool_bwd"),
        "raw": {"x_shape": [n, h, w_sp, c], "window": [ky, kx],
                "sliding": [sx, sy]},
    }
