"""The port's learned cost model, measurement sidecar and fleet bank
(veles_tpu_torch/tune/costmodel.py, tune/cache.py) against the JAX
package's: featurization over the port's genes, the deterministic
boosted stumps (bit-equal to JAX's on the same rows), Spearman, the
leave-one-spec-out trust gate, the sidecar's staleness filters and
compaction, and the bank's export, merge policy, rejections and
counters.  Pure numpy and JSON: nothing launches.

Every test sees a private empty cache and sidecar (the conftest
redirects ``VELES_SCHEDULE_CACHE`` to tmp)."""

import json
import os

import numpy
import pytest

from veles_tpu_torch.tune import cache as tcache
from veles_tpu_torch.tune import costmodel
from veles_tpu_torch.tune.spec import attention_spec, matmul_spec


def _matmul_rows(shapes, schedules, slope_fn, mode="measure",
                 kind=None):
    """Synthetic sidecar rows keyed exactly as the tuner writes them."""
    from veles_tpu_torch.ops.common import PORT_KERNEL_VERSIONS
    kind = kind or tcache.device_kind()
    rows = []
    for shape in shapes:
        digest, payload = tcache.schedule_key(
            "matmul", shape, "float32", 0, kind,
            {"kernel_version": PORT_KERNEL_VERSIONS["matmul"]})
        for schedule in schedules:
            rows.append({"digest": digest, "payload": payload,
                         "schedule": dict(schedule),
                         "slope": slope_fn(shape, schedule), "mode": mode})
    return rows


#: matmul schedules across the port's genes
_SCHEDULES = [{"bk": bk, "splits": splits}
              for bk in (64, 128, 256, 512) for splits in (1, 2, 4)]

_SHAPES = [(512, 512, 512), (1024, 1024, 1024), (512, 1024, 2048),
           (2048, 512, 1024)]


def _grid_slope(shape, schedule):
    """A learnable synthetic cost: K-tiles times a per-tile cost that
    rewards deep tiles, less a split's share."""
    m, k, n = shape
    tiles = -(-k // schedule["bk"])
    return tiles * (1.0 + 64.0 / schedule["bk"]) * m * n * 1e-12 / \
        (1.0 + 0.1 * schedule["splits"])


def _append(rows):
    log = tcache.measurement_log()
    for row in rows:
        log.append(row["digest"], row["payload"], row["schedule"],
                   row["slope"], mode=row["mode"])
    return log


# -- featurize / spearman -----------------------------------------------------


def test_featurize_fixed_length_and_deterministic():
    spec = matmul_spec(512, 512, 512, "float32", 0)
    a = costmodel.featurize(spec, {"bk": 64, "splits": 1})
    b = costmodel.featurize(spec, {"bk": 64, "splits": 1})
    c = costmodel.featurize(spec, {"bk": 256, "splits": 4})
    # 3 shape dims + 2 genes + 5 derived features
    assert a.shape == (10,) and c.shape == (10,)
    numpy.testing.assert_array_equal(a, b)
    assert not numpy.array_equal(a, c)


@pytest.mark.parametrize("spec,schedules", [
    (attention_spec(4, 256, 64, "float32", 0), ({"grid": 8}, {"grid": 0})),
    ({"op": "conv_vjp", "shape": [9, 6272, 512, 512], "dtype": "float32",
      "precision_level": 0},
     ({"tile": [128, 64], "chunk": 800}, {"tile": [128, 128],
                                          "chunk": 1600})),
    ({"op": "matmul_int8", "shape": [100352, 1152, 256], "dtype": "int8",
      "precision_level": 0},
     ({"config": 0, "splits": 1}, {"config": 2, "splits": 4})),
    ({"op": "pool_bwd", "shape": [2, 8, 8, 64, 4, 4, 2, 2, 2, 2],
      "dtype": "float32", "precision_level": 0},
     ({"design": "cells", "lanes_x": 16}, {"design": "overlap",
                                           "lanes_x": 2})),
])
def test_featurize_every_family_reads_the_port_genes(spec, schedules):
    a, b = (costmodel.featurize(spec, s) for s in schedules)
    assert a.shape == b.shape and not numpy.array_equal(a, b)
    assert numpy.isfinite(a).all() and numpy.isfinite(b).all()


def test_spearman_sanity():
    assert costmodel.spearman([1, 2, 3, 4], [10, 20, 30, 40]) == \
        pytest.approx(1.0)
    assert costmodel.spearman([1, 2, 3, 4], [40, 30, 20, 10]) == \
        pytest.approx(-1.0)
    assert costmodel.spearman([1, 2, 3, 4], [1, 100, 1e4, 1e6]) == \
        pytest.approx(1.0)
    assert costmodel.spearman([1, 1, 1], [1, 2, 3]) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_matches_jax(seed):
    from veles_tpu.tune import costmodel as jax_costmodel
    rng = numpy.random.RandomState(seed)
    a = rng.randint(0, 6, 25).astype(float)   # ties included
    b = rng.rand(25)
    assert costmodel.spearman(a, b) == jax_costmodel.spearman(a, b)


# -- fit / predict ------------------------------------------------------------


def test_fit_is_deterministic():
    rows = _matmul_rows(_SHAPES, _SCHEDULES, _grid_slope)
    m1 = costmodel.CostModel("matmul").fit(rows)
    m2 = costmodel.CostModel("matmul").fit(list(rows))
    assert m1.base == m2.base and m1.stumps == m2.stumps
    spec = matmul_spec(768, 768, 768, "float32", 0)
    assert m1.predict_rank(spec, _SCHEDULES) == \
        m2.predict_rank(spec, _SCHEDULES)


def test_model_recovers_synthetic_ordering():
    rows = _matmul_rows(_SHAPES, _SCHEDULES, _grid_slope)
    model = costmodel.CostModel("matmul").fit(rows)
    spec = matmul_spec(1536, 1536, 1536, "float32", 0)
    pred = model.predict_seconds(spec, _SCHEDULES)
    actual = [_grid_slope((1536, 1536, 1536), s) for s in _SCHEDULES]
    assert costmodel.spearman(pred, actual) > 0.8
    val = model.validate()
    assert val["groups"] >= 3 and val["error"] < 0.5


def test_predict_rank_ties_break_on_lower_index():
    rows = _matmul_rows(_SHAPES[:2], _SCHEDULES[:4], lambda shape, s: 1e-3)
    model = costmodel.CostModel("matmul").fit(rows)
    spec = matmul_spec(512, 512, 512, "float32", 0)
    assert model.predict_rank(spec, _SCHEDULES[:4]) == [0, 1, 2, 3]


def test_fit_empty_rows_raises():
    with pytest.raises(ValueError):
        costmodel.CostModel("matmul").fit([])


def _shared_features(spec, schedule):
    """One featurization for both packages' models (their genes
    differ): log2 of the shape and the schedule's values."""
    values = [float(v) for _, v in sorted(schedule.items())]
    return numpy.asarray([numpy.log2(max(float(s), 1.0))
                          for s in spec["shape"]] + values, numpy.float64)


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_cost_model_is_bit_equal_to_jax_on_the_same_rows(noise,
                                                         monkeypatch):
    """The same rows through the same features: the same stumps,
    bit-equal predictions, the same leave-one-spec-out Spearman and so
    the same trust decision (learnable rows trusted, noise refused)."""
    from veles_tpu.tune import costmodel as jax_costmodel
    monkeypatch.setattr(costmodel, "featurize", _shared_features)
    monkeypatch.setattr(jax_costmodel, "featurize", _shared_features)
    rng = numpy.random.RandomState(3)
    rows = []
    for i, shape in enumerate(_SHAPES):
        payload = {"op": "matmul", "shape": list(shape)}
        for a in range(5):
            for b in range(3):
                slope = (_grid_slope(shape, {"bk": 64 * (a + 1),
                                             "splits": b + 1})
                         * (1 - noise) + noise * rng.rand())
                rows.append({"digest": "d%d" % i, "payload": payload,
                             "schedule": {"a": a, "b": b},
                             "slope": slope})
    ours = costmodel.CostModel("matmul").fit(rows)
    theirs = jax_costmodel.CostModel("matmul").fit(rows)
    assert ours.base == theirs.base and ours.stumps == theirs.stumps
    spec = {"op": "matmul", "shape": [768, 768, 768]}
    probe = [{"a": a, "b": b} for a in range(5) for b in range(3)]
    numpy.testing.assert_array_equal(ours.predict_seconds(spec, probe),
                                     theirs.predict_seconds(spec, probe))
    v_ours, v_theirs = ours.validate(), theirs.validate()
    assert v_ours == v_theirs
    trusted = v_ours["error"] is not None and \
        v_ours["error"] <= costmodel.TRUST_ERROR
    assert trusted == (v_theirs["error"] is not None and
                       v_theirs["error"] <= jax_costmodel.TRUST_ERROR)
    assert trusted == (noise == 0.0)


# -- trust gates --------------------------------------------------------------


def test_train_for_thin_data_fallback():
    _append(_matmul_rows(_SHAPES[:1], _SCHEDULES[:3], _grid_slope))
    model, info = costmodel.train_for("matmul", mode="measure")
    assert model is None and info["fallback"] == "thin-data"
    assert info["triples"] == 3 and not info["trusted"]


def test_train_for_untrusted_on_noise():
    rng = numpy.random.RandomState(7)
    noise = {}

    def random_slope(shape, schedule):
        key = (tuple(shape), json.dumps(schedule, sort_keys=True))
        if key not in noise:
            noise[key] = float(rng.uniform(1e-6, 1e-3))
        return noise[key]
    _append(_matmul_rows(_SHAPES, _SCHEDULES, random_slope))
    model, info = costmodel.train_for("matmul", mode="measure")
    assert model is None and info["fallback"] == "untrusted"
    assert info["error"] is not None and info["error"] > 0.5


def test_train_for_unvalidatable_reads_untrusted():
    shapes = [(8 * i, 128 * i, 128 * i) for i in range(1, 20)]
    _append(_matmul_rows(shapes, _SCHEDULES[:2], _grid_slope))
    model, info = costmodel.train_for("matmul", mode="measure")
    assert model is None and info["fallback"] == "untrusted"
    assert info["error"] is None and info["groups"] == 0


def test_train_for_trusts_learnable_data():
    _append(_matmul_rows(_SHAPES, _SCHEDULES, _grid_slope))
    model, info = costmodel.train_for("matmul", mode="measure")
    assert model is not None and info["trusted"]
    assert info["fallback"] is None
    assert info["error"] < 0.5 and info["groups"] >= 3


def test_train_for_reads_the_named_device_kind_only():
    _append(_matmul_rows(_SHAPES, _SCHEDULES, _grid_slope,
                         kind="NVIDIA H100 80GB HBM3"))
    assert costmodel.train_for("matmul")[1]["triples"] == 0
    assert costmodel.train_for(
        "matmul", kind="NVIDIA H100 80GB HBM3")[1]["triples"] == \
        len(_SHAPES) * len(_SCHEDULES)


# -- the measurement sidecar --------------------------------------------------


def test_measurement_log_roundtrip_and_filters(tmp_path):
    log = tcache.MeasurementLog(str(tmp_path / "m.jsonl"))
    rows = _matmul_rows(_SHAPES[:2], _SCHEDULES[:2], _grid_slope)
    for row in rows:
        log.append(row["digest"], row["payload"], row["schedule"],
                   row["slope"], mode=row["mode"])
    log.append(rows[0]["digest"], rows[0]["payload"], rows[0]["schedule"],
               2e-3, mode="compile")
    got = log.rows(op="matmul", mode="measure")
    assert len(got) == 4 and all(r["mode"] == "measure" for r in got)
    assert log.rows(mode="compile")[0]["slope"] == 2e-3
    assert log.count_by_family() == {"matmul": 5}


def test_measurement_log_strands_stale_rows(tmp_path):
    """Rows of another torch version, device kind or port kernel
    version, or with a digest that does not recompute, are kept out of
    the training data, as stale cache entries miss."""
    log = tcache.MeasurementLog(str(tmp_path / "m.jsonl"))
    good = _matmul_rows(_SHAPES[:1], _SCHEDULES[:1], _grid_slope)[0]
    log.append(good["digest"], good["payload"], good["schedule"],
               good["slope"])
    for mutate in ({"torch": "0.0.0"}, {"device_kind": "TPU v9"},
                   {"kernel_version": -1}, {"shape": [8, 128, 128]}):
        payload = dict(good["payload"])
        payload.update(mutate)
        log.append(good["digest"], payload, good["schedule"], 1e-3)
    assert len(log.rows()) == 1
    assert len(log.rows(current_only=False)) == 5


def test_measurement_log_recomputed_digest_gate(tmp_path):
    log = tcache.MeasurementLog(str(tmp_path / "m.jsonl"))
    good = _matmul_rows(_SHAPES[:1], _SCHEDULES[:1], _grid_slope)[0]
    log.append("deadbeef" * 8, good["payload"], good["schedule"], 1e-3)
    assert log.rows() == []
    assert len(log.rows(current_only=False)) == 1


def test_measurement_log_skips_garbage_lines(tmp_path, caplog):
    path = tmp_path / "m.jsonl"
    good = _matmul_rows(_SHAPES[:1], _SCHEDULES[:1], _grid_slope)[0]
    log = tcache.MeasurementLog(str(path))
    log.append(good["digest"], good["payload"], good["schedule"], 1e-3)
    with open(str(path), "a") as fout:
        fout.write("not json\n")
        fout.write(json.dumps({"digest": "x"}) + "\n")
    with caplog.at_level("WARNING"):
        assert len(log.rows()) == 1
    assert any("unparseable" in r.message for r in caplog.records)


def test_measurement_log_compaction_bound(tmp_path, monkeypatch):
    monkeypatch.setattr(tcache, "_MEASUREMENTS_MAX_BYTES", 2048)
    monkeypatch.setattr(tcache, "_MEASUREMENTS_KEEP", 5)
    log = tcache.MeasurementLog(str(tmp_path / "m.jsonl"))
    good = _matmul_rows(_SHAPES[:1], _SCHEDULES[:1], _grid_slope)[0]
    for i in range(40):
        log.append(good["digest"], good["payload"], good["schedule"],
                   1e-6 * (i + 1))
    rows = log.rows()
    assert len(rows) <= 8
    assert rows[-1]["slope"] == pytest.approx(1e-6 * 40)
    assert os.path.getsize(str(tmp_path / "m.jsonl")) <= 4096


def test_record_measurement_never_raises(monkeypatch, caplog):
    def boom(*args, **kwargs):
        raise OSError("read-only cache dir")
    monkeypatch.setattr(tcache.MeasurementLog, "append", boom)
    with caplog.at_level("WARNING"):
        tcache.record_measurement("d", {"op": "matmul"},
                                  {"bk": 64, "splits": 1}, 1e-3)
    assert any("triple dropped" in r.message for r in caplog.records)


# -- the fleet schedule bank --------------------------------------------------


def _planted_cache(tmp_path, name, fitness=-1e-3):
    """A cache with one really keyed matmul entry."""
    from veles_tpu_torch.ops.common import PORT_KERNEL_VERSIONS
    digest, payload = tcache.schedule_key(
        "matmul", (512, 512, 512), "float32", 0, tcache.device_kind(),
        {"kernel_version": PORT_KERNEL_VERSIONS["matmul"]})
    cache = tcache.ScheduleCache(str(tmp_path / name))
    cache.put(digest, payload, {"bk": 256, "splits": 2}, fitness=fitness,
              evals=4, source="ga")
    return cache, digest


def test_bank_export_merge_roundtrip(tmp_path):
    ours, digest = _planted_cache(tmp_path, "a.json")
    bank_path = str(tmp_path / "bank.json")
    assert ours.export_bank(bank_path) == 1
    bank = tcache.load_bank(bank_path)
    assert bank["kind"] == "schedule_bank" and "torch" in bank
    assert bank["entries"][digest]["host"]
    theirs = tcache.ScheduleCache(str(tmp_path / "b.json"))
    assert theirs.merge_bank(bank_path) == {
        "adopted": 1, "kept": 0, "stale": 0, "invalid": 0, "total": 1}
    got = theirs.get(digest)
    assert got["schedule"] == {"bk": 256, "splits": 2}
    assert got["fitness"] == -1e-3
    assert theirs.merge_bank(bank_path)["adopted"] == 0


def test_bank_merge_conflict_resolution(tmp_path):
    """The disk wins except on a strictly better measured fitness; an
    unmeasured challenger never displaces; an unmeasured incumbent yields
    to a measured one."""
    ours, digest = _planted_cache(tmp_path, "a.json", fitness=-2e-3)

    def bank_with(fitness, schedule):
        donor, _ = _planted_cache(tmp_path, "donor.json", fitness=fitness)
        payload = {k: v for k, v in donor.entries()[digest].items()
                   if k not in ("schedule", "source", "fitness", "evals",
                                "host")}
        donor.put(digest, payload, schedule, fitness=fitness, source="ga")
        path = str(tmp_path / "bank.json")
        donor.export_bank(path)
        os.remove(str(tmp_path / "donor.json"))
        return path

    counts = ours.merge_bank(bank_with(-5e-3, {"bk": 64, "splits": 1}))
    assert counts["kept"] == 1 and counts["adopted"] == 0
    assert ours.get(digest)["schedule"] == {"bk": 256, "splits": 2}
    counts = ours.merge_bank(bank_with(-1e-3, {"bk": 512, "splits": 1}))
    assert counts["adopted"] == 1
    assert ours.get(digest)["schedule"] == {"bk": 512, "splits": 1}
    counts = ours.merge_bank(bank_with(None, {"bk": 64, "splits": 1}))
    assert counts["kept"] == 1
    assert ours.get(digest)["schedule"] == {"bk": 512, "splits": 1}
    unmeasured = tcache.ScheduleCache(str(tmp_path / "u.json"))
    payload = {k: v for k, v in ours.entries()[digest].items()
               if k not in ("schedule", "source", "fitness", "evals",
                            "host")}
    unmeasured.put(digest, payload, {"bk": 64, "splits": 1})
    assert unmeasured.merge_bank(
        bank_with(-9e-3, {"bk": 128, "splits": 1}))["adopted"] == 1


def test_bank_merge_rejects_stale_digest_and_invalid(tmp_path):
    ours, digest = _planted_cache(tmp_path, "a.json")
    entry = dict(ours.entries()[digest])
    bank = {"schema": tcache.SCHEDULE_CACHE_SCHEMA, "kind": "schedule_bank",
            "host": "donor", "torch": "x",
            "entries": {
                "deadbeef" * 8: dict(entry),
                digest: dict(entry, schedule={"bk": 100, "splits": 1}),
            }}
    fresh = tcache.ScheduleCache(str(tmp_path / "b.json"))
    counts = fresh.merge_bank(bank)
    assert counts["stale"] == 1 and counts["invalid"] == 1
    assert counts["adopted"] == 0 and len(fresh) == 0


def test_load_bank_rejects_non_banks(tmp_path):
    path = str(tmp_path / "junk.json")
    with open(path, "w") as fout:
        json.dump({"schema": 1, "entries": {}}, fout)
    with pytest.raises(ValueError):
        tcache.load_bank(path)


def test_bank_counters_tick(tmp_path):
    from veles_tpu_torch.observe.metrics import registry
    ours, _ = _planted_cache(tmp_path, "a.json")
    bank_path = str(tmp_path / "bank.json")
    ours.export_bank(bank_path)
    before = tcache.tune_counters()
    tcache.ScheduleCache(str(tmp_path / "b.json")).merge_bank(bank_path)
    after = tcache.tune_counters()
    assert after.get("bank_merged", 0) == before.get("bank_merged", 0) + 1
    assert after.get("bank_entries", 0) == \
        before.get("bank_entries", 0) + 1
    assert registry.peek("tune.bank_merged") is not None
