"""The port's native bridge (veles_tpu_torch/native.py: the ctypes
binding and the g++ build of native/src without cmake) on packages the
port exports, against the port's CPU forward at the JAX tests'
tolerances, and against the JAX package's bridge.

- tests/test_native.py's cases on the port: the MLP, the fp16 package,
  the conv net, the arena's reuse, the malformed ``.npy``, the branching
  DAG, the DAG arena, the wavefront at batch 1, the adversarial order
  and the empty batch;
- tests/test_native_fuzz.py's cases, one parametrized case each: a
  hostile package raises a clean exception and never crashes the
  process;
- the port's build (g++, no cmake) and the JAX package's cmake build
  give the same bytes on the same packages, one exported by each
  package; a failed build raises.

These build the library (this machine has g++): once a process, into
``veles_tpu_torch/build/native_<digest>/`` under its lock.
"""

import io
import struct
import tarfile

import numpy
import pytest

import test_native_fuzz as fuzz
from torch_services import CPU, forward, train_conv, train_mlp


@pytest.fixture(scope="module")
def native():
    from veles_tpu_torch import native as native_mod
    native_mod.build_native()
    return native_mod


@pytest.fixture(scope="module")
def mlp():
    return train_mlp()


def test_export_and_native_mlp_inference(tmp_path, native, mlp):
    pkg = str(tmp_path / "mlp.veles.tar")
    mlp.package_export(pkg)
    nwf = native.NativeWorkflow(pkg)
    assert (nwf.unit_count, nwf.input_size, nwf.output_size) == (2, 16, 4)
    x = numpy.random.RandomState(0).rand(32, 16).astype(numpy.float32)
    got = nwf.run(x)
    numpy.testing.assert_allclose(got, forward(mlp, x), rtol=1e-4,
                                  atol=1e-5)
    numpy.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_native_fp16_package(tmp_path, native, mlp):
    pkg = str(tmp_path / "mlp16.veles.tar")
    mlp.package_export(pkg, precision="float16")
    x = numpy.random.RandomState(1).rand(8, 16).astype(numpy.float32)
    got = native.NativeWorkflow(pkg).run(x)
    numpy.testing.assert_allclose(got, forward(mlp, x), rtol=0.05,
                                  atol=0.02)


def test_native_conv_inference(tmp_path, native):
    sw = train_conv()
    pkg = str(tmp_path / "conv.veles.tar")
    sw.package_export(pkg)
    nwf = native.NativeWorkflow(pkg)
    assert nwf.unit_count == 3
    x = numpy.random.RandomState(2).rand(8, 8, 8, 1).astype(numpy.float32)
    numpy.testing.assert_allclose(nwf.run(x), forward(sw, x).reshape(8, -1),
                                  rtol=1e-3, atol=1e-4)


def test_arena_reuses_memory(tmp_path, native):
    layers = [{"type": "all2all_tanh", "output_sample_shape": 64,
               "learning_rate": 0.05} for _ in range(6)]
    layers.append({"type": "softmax", "output_sample_shape": 4,
                   "learning_rate": 0.05})
    sw = train_mlp(epochs=0, layers=layers)
    pkg = str(tmp_path / "deep.veles.tar")
    sw.package_export(pkg)
    nwf = native.NativeWorkflow(pkg)
    batch = 64
    total_naive = 6 * batch * 64 * 4 + batch * 4 * 4
    assert nwf.arena_size(batch) < total_naive
    out = nwf.run(numpy.random.RandomState(3).rand(4, 16))
    assert numpy.allclose(out.sum(axis=1), 1.0, atol=1e-4)


def test_native_rejects_malformed_npy(tmp_path, native, mlp):
    pkg = str(tmp_path / "ok.tar")
    mlp.package_export(pkg)
    evil = str(tmp_path / "evil.tar")
    with tarfile.open(pkg) as tin, tarfile.open(evil, "w") as tout:
        for member in tin.getmembers():
            data = tin.extractfile(member).read()
            if member.name.endswith(".npy"):
                data = data[:8] + struct.pack("<H", 0xFFFF) + data[10:]
            member.size = len(data)
            tout.addfile(member, io.BytesIO(data))
    with pytest.raises(RuntimeError):
        native.NativeWorkflow(evil)


def _unit(sw, cls, source, attr, width):
    unit = cls(sw, output_sample_shape=width, learning_rate=0.1)
    unit.link_attrs(source, ("input", attr))
    unit.initialize(device=CPU)
    unit.run()
    return unit


def _joiner(sw, units):
    from veles_tpu_torch.service_units import InputJoiner
    joiner = InputJoiner(sw)
    joiner.link_inputs(*[(u, "output") for u in units])
    joiner.initialize(device=CPU)
    joiner.run()
    return joiner


def _host(arr):
    arr.map_read()
    return numpy.ascontiguousarray(arr.mem, numpy.float32)


def test_native_branching_dag_inference(tmp_path, native):
    from veles_tpu_torch.models.all2all import (All2AllRELU, All2AllSoftmax,
                                                All2AllTanh)
    from veles_tpu_torch.package import export_workflow
    sw = train_mlp(epochs=1)
    loader = sw.loader
    branch_a = _unit(sw, All2AllTanh, loader, "minibatch_data", 8)
    branch_b = _unit(sw, All2AllRELU, loader, "minibatch_data", 12)
    joiner = _joiner(sw, [branch_a, branch_b])
    head = _unit(sw, All2AllSoftmax, joiner, "output", 4)
    pkg = str(tmp_path / "dag.tar")
    export_workflow(sw, pkg, units=[branch_a, branch_b, joiner, head])
    expected = _host(head.output)
    wf = native.NativeWorkflow(pkg)
    assert wf.unit_count == 4
    got = wf.run(_host(loader.minibatch_data)).reshape(expected.shape)
    numpy.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_native_dag_arena_overlaps_disjoint_lifetimes(tmp_path, native,
                                                      mlp):
    pkg = str(tmp_path / "chain.tar")
    mlp.package_export(pkg)
    batch = 16
    assert native.NativeWorkflow(pkg).arena_size(batch) <= \
        32 * batch * 4 + 4096


def test_native_wavefront_wide_graph_batch1(tmp_path, native):
    from veles_tpu_torch.models.all2all import All2AllSoftmax, All2AllTanh
    from veles_tpu_torch.package import export_workflow
    sw = train_mlp(epochs=1)
    loader = sw.loader
    branches = [_unit(sw, All2AllTanh, loader, "minibatch_data", 6 + k)
                for k in range(4)]
    joiner = _joiner(sw, branches)
    head = _unit(sw, All2AllSoftmax, joiner, "output", 4)
    pkg = str(tmp_path / "wide.tar")
    export_workflow(sw, pkg, units=branches + [joiner, head])
    x1 = _host(loader.minibatch_data)[:1]
    expected = _host(head.output)[:1]
    wf = native.NativeWorkflow(pkg)
    assert wf.unit_count == 6
    first = wf.run(x1).reshape(expected.shape)
    numpy.testing.assert_allclose(first, expected, rtol=1e-5, atol=1e-6)
    for _ in range(20):
        numpy.testing.assert_array_equal(
            wf.run(x1).reshape(expected.shape), first)


def test_native_arena_safe_under_wavefront_order(tmp_path, native):
    from veles_tpu_torch.models.all2all import All2AllTanh
    from veles_tpu_torch.package import export_workflow
    sw = train_mlp(epochs=1)
    loader = sw.loader
    a = _unit(sw, All2AllTanh, loader, "minibatch_data", 8)
    b = _unit(sw, All2AllTanh, loader, "minibatch_data", 8)
    c = _unit(sw, All2AllTanh, a, "output", 8)
    join = _joiner(sw, [c, b])
    pkg = str(tmp_path / "adversarial.tar")
    export_workflow(sw, pkg, units=[a, c, b, join])
    x = _host(loader.minibatch_data)
    expected = _host(join.output)
    wf = native.NativeWorkflow(pkg)
    for _ in range(10):
        numpy.testing.assert_allclose(wf.run(x).reshape(expected.shape),
                                      expected, rtol=1e-5, atol=1e-6)


def test_native_empty_batch(tmp_path, native, mlp):
    pkg = str(tmp_path / "empty.tar")
    mlp.package_export(pkg)
    wf = native.NativeWorkflow(pkg)
    assert wf.run(numpy.empty((0, wf.input_size), numpy.float32)).size == 0


# -- tests/test_native_fuzz.py's cases on the port's bridge -------------------


def test_valid_baseline_package_loads(tmp_path, native):
    pkg = str(tmp_path / "ok.tar")
    fuzz._make_package(pkg, fuzz._valid_contents(), fuzz._valid_members())
    out = native.NativeWorkflow(pkg).run(
        numpy.random.RandomState(1).rand(3, 16))
    assert out.shape == (3, 4)
    assert numpy.allclose(out.sum(axis=1), 1.0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(fuzz._schema_mutations()))
def test_hostile_contents_schema(tmp_path, native, name):
    contents = fuzz._valid_contents()
    fuzz._schema_mutations()[name](contents)
    pkg = str(tmp_path / (name + ".tar"))
    fuzz._make_package(pkg, contents, fuzz._valid_members())
    try:
        wf = native.NativeWorkflow(pkg)
        wf.run(numpy.random.RandomState(1).rand(2, 16))
    except (RuntimeError, ValueError, MemoryError):
        pass


@pytest.mark.parametrize("name", sorted(fuzz._RAW_JSON))
def test_hostile_raw_json(tmp_path, native, name):
    pkg = str(tmp_path / (name + ".tar"))
    with tarfile.open(pkg, "w") as tout:
        info = tarfile.TarInfo("contents.json")
        info.size = len(fuzz._RAW_JSON[name])
        tout.addfile(info, io.BytesIO(fuzz._RAW_JSON[name]))
    with pytest.raises(RuntimeError):
        native.NativeWorkflow(pkg)


def _tar_block(name, size_field):
    block = bytearray(512)
    block[0:len(name)] = name
    block[124:136] = size_field
    block[156] = ord("0")
    return bytes(block)


_TAR_CASES = {
    "empty_file": b"",
    "end_marker_only": b"\0" * 1024,
    "truncated_header": b"x" * 100,
    "oversized_member": _tar_block(b"contents.jso", b"77777777777\0"),
    "truncated_member": _tar_block(b"contents.jso", b"00000001750\0"),
    "garbage_size_field": _tar_block(b"cont.txt", b"zzzzzzzzzzz\0"),
}


@pytest.mark.parametrize("name", sorted(_TAR_CASES))
def test_hostile_tar_structures(tmp_path, native, name):
    path = str(tmp_path / (name + ".tar"))
    with open(path, "wb") as fout:
        fout.write(_TAR_CASES[name])
    with pytest.raises(RuntimeError):
        native.NativeWorkflow(path)


_NPY_MUTATIONS = {
    "bad_magic": lambda d: b"\x00NOPE" + d[5:],
    "truncated_payload": lambda d: d[: len(d) // 2],
    "object_dtype": lambda d: d.replace(b"<f4", b"|O8"),
    "header_len_overrun": lambda d: (
        d[:8] + struct.pack("<H", 0xFFFF) + d[10:]),
}


@pytest.mark.parametrize("name", sorted(_NPY_MUTATIONS))
def test_hostile_npy_members(tmp_path, native, name):
    members = fuzz._valid_members()
    members["w0.npy"] = _NPY_MUTATIONS[name](members["w0.npy"])
    pkg = str(tmp_path / (name + ".tar"))
    fuzz._make_package(pkg, fuzz._valid_contents(), members)
    with pytest.raises(RuntimeError):
        native.NativeWorkflow(pkg)


def test_random_byte_flips_never_crash(tmp_path, native):
    pkg = str(tmp_path / "base.tar")
    fuzz._make_package(pkg, fuzz._valid_contents(), fuzz._valid_members())
    base = open(pkg, "rb").read()
    rng = numpy.random.RandomState(42)
    survived, rejected = 0, 0
    for i in range(20):
        data = bytearray(base)
        pos = int(rng.randint(0, len(data)))
        data[pos] ^= int(rng.randint(1, 256))
        path = str(tmp_path / ("flip%02d.tar" % i))
        with open(path, "wb") as fout:
            fout.write(bytes(data))
        try:
            out = native.NativeWorkflow(path).run(
                numpy.random.RandomState(1).rand(2, 16))
            assert out.shape[0] == 2
            survived += 1
        except (RuntimeError, ValueError, MemoryError):
            rejected += 1
    assert survived + rejected == 20


# -- the two builds -----------------------------------------------------------


def test_port_build_equals_jax_cmake_build(tmp_path, native, mlp, cpu_device):
    """A JAX-exported and a port-exported package, each run by the
    port's library (g++) and the JAX package's (cmake): the same bytes."""
    from veles_tpu import native as jax_native
    from test_native import _train_mlp
    jax_native.build_native()
    jax_pkg = str(tmp_path / "jax.tar")
    _train_mlp(cpu_device, epochs=1).package_export(jax_pkg)
    port_pkg = str(tmp_path / "port.tar")
    mlp.package_export(port_pkg)
    x = numpy.random.RandomState(7).rand(64, 16).astype(numpy.float32)
    for pkg in (jax_pkg, port_pkg):
        got = native.NativeWorkflow(pkg)
        want = jax_native.NativeWorkflow(pkg)
        assert (got.unit_count, got.input_size, got.output_size,
                got.arena_size(64)) == (want.unit_count, want.input_size,
                                        want.output_size,
                                        want.arena_size(64))
        assert got.run(x).tobytes() == want.run(x).tobytes()


def test_build_layout_and_failure(tmp_path, native, monkeypatch):
    import os
    path = native.build_native()
    assert os.path.dirname(path) == os.path.join(
        native.BUILD_DIR, "native_" + native.source_digest())
    assert native.native_available()
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError) as err:
        native.build_native(force=True)
    assert "native build failed" in str(err.value)
