"""The production-mesh dry run (``launch/dryrun.py``: ``run_case``,
``cells``, ``main``, ``measure_step``), the collective census
(``analysis/census.py``) and ``count_step`` on a mesh, on one rank of a
fake process group under ``FakeTensorMode``, held to the reference:

  * the census's result bytes on ``tests/test_train_infra.py``'s example
    (an all-reduce of f32[16], an all-gather into bf16[4, 8]) against the
    reference's ``collective_stats`` of the same HLO;
  * the per-device argument bytes of the reference's mini dry-run trio on a
    (2, 4) mesh against the bytes the reference's own specs give its
    ``jax.eval_shape`` trees on a stand-in mesh (exactly);
  * a DTensor op counted as its local shard;
  * reduced phi4's per-device FLOPs on (2, 4) against the reference's
    ``hlo_counter`` of the same cells, compiled on 8 forced host devices in
    one subprocess (``tests/test_multidevice.py``'s way);
  * a 16x16 train cell whose microbatches (8) are fewer than its data
    ranks (16), which raised before the batch split's all-to-all;
  * the memory record: alias the donated inputs' bytes, every number the
    same in two runs whether or not the garbage collector runs;
  * ``main`` on a full-width cell, its record's keys the reference's.

Every fake group is started and destroyed inside its test (no test process
keeps a process group); the xlstm census against the gloo ranks' lives in
``tests/test_torch_sharded.py``, beside the shared gloo launch.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_parity import one_cpu_thread  # noqa: F401  (module fixture)
from repro.analysis.hlo import collective_stats as ref_collective_stats
from repro.configs import get_arch as ref_get_arch
from repro.distributed import sharding as ref_sharding
from repro.launch import dryrun as ref_dryrun
from repro_torch.analysis import census, roofline
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import Mesh

TRIO = ("qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-large-v3")
TRAIN, DECODE = ShapeSpec("t", 64, 8, "train"), ShapeSpec("d", 64, 8, "decode")
PREFILL = ShapeSpec("p", 64, 8, "prefill")
MESH_2x4 = Mesh(("data", "model"), np.arange(8).reshape(2, 4), "cpu")
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference's keys of a dry-run record (``repro/launch/dryrun.py``'s
# ``run_case``; XLA's raw cost_analysis FLOPs have no counterpart)
RECORD_KEYS = {"arch", "shape", "mesh", "ok", "compile_s", "memory", "counted_flops",
               "counted_bytes", "counted_transcendentals", "unknown_trip_counts",
               "collectives", "collective_gb_per_device", "roofline"}
MEMORY_KEYS = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_gb"}


def _cfg(name, microbatches=2):
    return dataclasses.replace(get_arch(name).reduced(), microbatches=microbatches)


def _fake_cell(name, shape, mesh_shape):
    """``measure_step`` of ``build_case``'s step on a fake group's mesh."""
    with dryrun.fake_group(8):
        mesh = M.make_mesh(mesh_shape, ("data", "model"), device="cpu")
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args = dryrun.build_case(_cfg(name), shape, mesh)
                return dryrun.measure_step(fn, args)
        finally:
            dryrun.clear_ctx()


_REF_HLO = """
    import dataclasses, json
    import jax
    from jax.sharding import AxisType
    from repro.analysis import hlo_counter
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.launch.dryrun import build_case

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(), microbatches=2)
    out = {}
    for kind in ("train", "prefill"):
        with mesh:
            fn, args = build_case(cfg, ShapeSpec(kind, 64, 8, kind), mesh)
            out[kind] = hlo_counter.analyze(fn.lower(*args).compile().as_text())["flops"]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def ref_hlo_proc():
    """The reference's compiles of reduced phi4's train and prefill cells on
    (2, 4) for ``hlo_counter``, in a subprocess with 8 forced host devices
    (its mesh's axes "Auto", as the reference's dry run needs them for
    ``with_sharding_constraint``), started when the module's first test
    starts so that it runs beside them."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF_HLO)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_hlo_flops(ref_hlo_proc):
    """The reference's per-device ``hlo_counter`` FLOPs of those cells."""
    out, err = ref_hlo_proc.communicate(timeout=600)
    assert ref_hlo_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_census_counts_the_references_example():
    """``tests/test_train_infra.py``'s HLO: an all-reduce of f32[16] (64
    bytes) and an all-gather into bf16[4, 8] (64 bytes), 128 in all; the
    all-gather's operand (bf16[1, 8]) is 16 bytes."""
    hlo = """
ENTRY %main (a: f32[16]) -> f32[16] {
  %ar = f32[16]{0} all-reduce(%a), replica_groups={}
  %ag = bf16[4,8]{1,0} all-gather(%b), dimensions={0}
  ROOT %r = f32[16]{0} add(%ar, %ar)
}
"""
    with dryrun.fake_group(4):
        with census.Census() as cs:
            dist.all_reduce(torch.ones(16))
            dist.all_gather_into_tensor(torch.empty(4, 8, dtype=torch.bfloat16),
                                        torch.ones(1, 8, dtype=torch.bfloat16))
    stats = census.collective_stats(cs)
    want = ref_collective_stats(hlo)
    assert {k: (v["count"], v["bytes"]) for k, v in stats.items()} == \
        {k: (v["count"], v["bytes"]) for k, v in want.items()}
    assert stats["all-reduce"]["bytes"] == 64 and stats["all-gather"]["bytes"] == 64
    assert census.total_collective_bytes(cs) == 128
    assert [c.operand_bytes for c in cs.collectives] == [64, 16]
    assert census.op_census(cs, ("ones", "empty", "mm")) == {"ones": 2, "empty": 1, "mm": 0}
    assert not dist.is_initialized()


def _ref_bytes(tree, specs, sizes) -> int:
    """Per-device bytes of a tree of ``jax.ShapeDtypeStruct`` placed by
    ``specs`` on a mesh of ``sizes``."""
    import jax

    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
        split = 1
        for entry in spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                split *= sizes[a]
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        assert n % split == 0
        total += n // split
    return total


def _reference_argument_bytes(name, shape) -> int:
    """The reference's per-device argument bytes of the cell: its own specs
    on its ``jax.eval_shape`` trees, on a stand-in (2, 4) mesh."""
    import jax

    cfg = dataclasses.replace(ref_get_arch(name).reduced(), microbatches=2)
    sizes = {"data": 2, "model": 4}
    batch = ref_dryrun.input_specs(cfg, shape)
    total = _ref_bytes(batch, ref_sharding.batch_specs(cfg, batch, MESH_2x4), sizes)
    if shape.kind == "train":
        params, opt = ref_dryrun.abstract_state(cfg, with_opt=True)
        total += _ref_bytes(params, ref_sharding.param_specs(cfg, params, MESH_2x4), sizes)
        return total + _ref_bytes(opt, ref_sharding.opt_specs(cfg, params, MESH_2x4), sizes)
    params, _ = ref_dryrun.abstract_state(cfg, with_opt=False)
    total += _ref_bytes(params, ref_sharding.param_specs(cfg, params, MESH_2x4), sizes)
    cache = jax.eval_shape(lambda: ref_dryrun.Model(cfg).cache_struct(
        shape.global_batch, shape.seq_len))
    total += _ref_bytes(cache, ref_sharding.cache_specs(cfg, cache, MESH_2x4), sizes)
    return total


@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
@pytest.mark.parametrize("name", TRIO)
def test_argument_bytes_are_the_references(name, shape):
    """The mini dry-run trio on a (2, 4) fake mesh: each rank's argument
    bytes (parameters, Adam's state and the batch; or parameters, cache and
    tokens), as ``measure_step`` counts them, equal what the reference's
    specs give, byte for byte."""
    with dryrun.fake_group(8):
        mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                _, args = dryrun.build_case(_cfg(name), shape, mesh)
                got = dryrun.local_bytes(args)
        finally:
            dryrun.clear_ctx()
    assert got == _reference_argument_bytes(name, shape)


def test_a_dtensor_op_counts_its_local_shard():
    """On a (2, 4) fake mesh, x (64, 32) sharded on "data" times w (32, 16)
    sharded on "model": one rank multiplies (32, 32) by (32, 4), so
    2·32·32·4 FLOPs and the bytes of its three local tensors; DTensor's
    sharding propagation (an op on the global shapes) is not counted,
    whether or not its cache held the op."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_group(8):
        dm = M.make_mesh((2, 4), ("data", "model"), device="cpu").device_mesh
        x = distribute_tensor(torch.ones(64, 32), dm, [Shard(0), Replicate()])
        w = distribute_tensor(torch.ones(32, 16), dm, [Replicate(), Shard(1)])
        for _ in range(2):
            c = roofline.count_step(torch.mm, x, w)
            assert c["flops"] == 2 * 32 * 32 * 4
            assert c["bytes"] == (32 * 32 + 32 * 4 + 32 * 4) * 4
            assert c["collective_bytes"] == 0 and c["collectives"] == {}
        c = roofline.count_step(lambda a: a * 2, x)
        assert c["flops"] == 0 and c["bytes"] == 2 * 32 * 32 * 4


def _replicated_flops(cfg, rows, seq, model):
    """Reduced phi4's matrix-product FLOPs that one rank of a ("data",
    "model") mesh runs beyond its share, per pass over ``rows`` x ``seq``
    tokens: the key and value projections (2 KV heads do not split over 4
    "model" ranks, so each rank projects both; the reference splits their
    columns) and the tied LM head (the port gathers the embedding; the
    reference splits the vocabulary) over ``seq`` positions."""
    d, kv, hd, v = cfg.d_model, cfg.num_kv_heads, cfg.head_dim_, cfg.vocab_size
    share = (model - 1) / model
    kv_proj = cfg.num_layers * 2 * rows * seq * d * 2 * kv * hd * share
    head = 2 * rows * seq * d * v * share
    return kv_proj, head


def test_count_step_per_device_flops_against_hlo_counter(ref_hlo_flops):
    """Reduced phi4 on (2, 4), the port's per-device counted FLOPs against
    the reference's ``hlo_counter`` per-device FLOPs of the same cells.

    On a data-only (8, 1) mesh the two agree (prefill exactly); the (2, 4)
    gap is the work the port replicates over "model"
    (:func:`_replicated_flops`): the prefill runs it once, with the LM head
    on the last position only; the train step runs the KV projections 4.5
    times (forward, the layer checkpoint's and half its group checkpoint's
    recompute, two backward products) and the head 4 times (forward, the
    chunked cross-entropy checkpoint's recompute, two backward products).
    What remains of the train step is remat: XLA recomputes more than
    PyTorch's checkpoints (the port's one-rank count is 0.92x the
    reference's), held within 10%.  Measured: prefill 1.30x, train 1.39x
    before the replicated work is taken out."""
    cfg = _cfg("phi4-mini-3.8b")
    rows = 4   # the rows of a "data" rank: 8 over 2
    pre = _fake_cell("phi4-mini-3.8b", PREFILL, (2, 4))["counts"]["flops"]
    kv, head = _replicated_flops(cfg, rows, 64, 4)
    _, head_last = _replicated_flops(cfg, rows, 1, 4)
    assert pre - kv - head_last == pytest.approx(ref_hlo_flops["prefill"], rel=1e-9)
    assert 1.2 < pre / ref_hlo_flops["prefill"] < 1.4
    train = _fake_cell("phi4-mini-3.8b", TRAIN, (2, 4))["counts"]["flops"]
    own = train - 4.5 * kv - 4 * head
    assert own == pytest.approx(ref_hlo_flops["train"], rel=0.10)
    assert 0.9 * ref_hlo_flops["train"] < own <= ref_hlo_flops["train"]
    assert 1.3 < train / ref_hlo_flops["train"] < 1.5


def test_a_16x16_train_cell_with_fewer_microbatches_than_data_ranks_runs():
    """Reduced phi4 (one layer) at (32, 256) with 8 microbatches on the
    16x16 mesh: 16 data ranks share 8 microbatches, which DTensor cannot
    unflatten; the batch split's one all-to-all moves each rank's 16 rows
    so that every microbatch holds 2 rows of each rank.  Its memory keeps
    the reference's identity."""
    shape = ShapeSpec("t16", 32, 256, "train")
    cfg = dataclasses.replace(_cfg("phi4-mini-3.8b", 8), num_layers=1)
    assert dryrun.microbatch_count(cfg, shape, 16) == 8
    with dryrun.fake_group(256):
        mesh = M.make_mesh((16, 16), ("data", "model"), device="cpu")
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args = dryrun.build_case(cfg, shape, mesh)
                m = dryrun.measure_step(fn, args)
        finally:
            dryrun.clear_ctx()
    c, mem = m["counts"], m["memory"]
    assert c["flops"] > 0 and c["collectives"]["all-to-all"]["count"] == 1
    # the tokens' rows: 16 a rank, int32, 32 a row
    assert c["collectives"]["all-to-all"]["bytes"] == 16 * 32 * 4
    assert mem["peak"] >= mem["argument"] and mem["temp"] >= 0
    assert mem["temp"] == mem["peak"] - mem["argument"] - mem["output"] + mem["alias"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("name, shape", [("phi4-mini-3.8b", TRAIN),
                                         ("whisper-large-v3", DECODE)])
def test_memory_is_the_donated_bytes_and_the_same_every_run(name, shape):
    """alias is the bytes of the inputs a step consumes (a train step's
    parameters and Adam's state, a decode step's cache: the reference's
    donated arguments), and the whole memory record is the same in two runs
    in a row, the garbage collector on in one and off in the other."""
    mems = []
    for collect in (True, False):
        with dryrun.fake_group(8):
            mesh = M.make_mesh((2, 4), ("data", "model"), device="cpu")
            try:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    fn, args = dryrun.build_case(_cfg(name), shape, mesh)
                    donated = sum(dryrun.local_bytes(args[i]) for i in fn.donates)
                    if not collect:
                        gc.disable()
                    try:
                        mem = dryrun.measure_step(fn, args)["memory"]
                    finally:
                        gc.enable()
            finally:
                dryrun.clear_ctx()
        assert mem["alias"] == donated > 0
        assert mem["temp"] == mem["peak"] - mem["argument"] - mem["output"] + mem["alias"] > 0
        mems.append(mem)
    assert mems[0] == mems[1]


def test_main_runs_a_full_width_cell(tmp_path, capsys):
    """``main`` on full-width phi4-mini ``decode_32k`` on the 16x16 fake
    group: exit 0, one record with the reference's keys, fitting 80 GB
    with the KV cache split on its slots (no all-gather of the cache)."""
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k", "--device", "cpu",
                        "--out", str(out)]) == 0
    assert "1/1 cells ran" in capsys.readouterr().out
    (rec,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["unknown_trip_counts"] == 0
    assert 0 < rec["memory"]["peak_gb"] < 80
    # the cache is 0.55 TB in bf16; a rank's share is 1/256 of it
    assert rec["collective_gb_per_device"] < 4
    assert rec["roofline"]["mesh"] == "16x16" and rec["counted_flops"] > 0
    assert not dist.is_initialized()


def test_cells_are_the_references():
    assert list(dryrun.cells()) == list(ref_dryrun.cells())
    assert list(dryrun.cells("zamba2-1.2b")) == [
        ("zamba2-1.2b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
