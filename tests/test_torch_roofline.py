"""The port's roofline (``analysis/roofline.py``, ``analysis/report.py``)
against ``repro``'s: ``model_flops`` equal for every shape cell of every
architecture; the ``Roofline`` terms held to their formulas at the port's
H100 constants, as ``tests/test_analysis_and_specs.py`` holds the
reference's at its own; the report's tables (the roofline's and the dry
run's) rendering the same rows as the reference's; and ``count_step``'s counted FLOPs of a reduced dense
``loss_fn`` forward and backward against an analytic count written out
here (rtol 1e-2; measured: equal), with and without remat.

The reference counts with XLA's ``cost_analysis()``, which counts a scanned
layer stack's body once; the port's counts are held to the analytic count
instead, never to the reference's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
from repro.configs import base as jbase
from repro_torch import configs as tconfigs
from repro_torch.analysis import report as treport
from repro_torch.analysis import roofline as troof
from repro_torch.configs import base as tbase
from repro_torch.models import lm as TLM
from repro_torch.train.data import synthetic_batch
from repro_torch.train.trainer import loss_and_grads

ARCHS = jconfigs.list_archs()


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_matches_the_reference(name):
    jcfg, tcfg = jconfigs.get_arch(name), tconfigs.get_arch(name)
    jcells, tcells = jbase.shape_cells(jcfg), tbase.shape_cells(tcfg)
    assert [c.name for c in tcells] == [c.name for c in jcells]
    for jc, tc in zip(jcells, tcells):
        assert troof.model_flops(tcfg, tc) == jroof.model_flops(jcfg, jc)


def test_roofline_constants_are_the_h100s():
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("flops,byts,coll,bottleneck", [
    (1e18, 1e15, 1e14, "compute"),
    (1e15, 1e15, 1e12, "memory"),
    (1e12, 1e12, 1e14, "collective"),
])
def test_roofline_terms_and_bottleneck(flops, byts, coll, bottleneck):
    r = troof.Roofline(arch="x", shape="train_4k", mesh="16x16", chips=256,
                       hlo_flops=flops, hlo_bytes=byts, collective_bytes=coll,
                       model_flops=flops / 2, per_device_hbm_bytes=8e9)
    assert abs(r.t_compute - flops / (256 * 989e12)) < 1e-12
    assert abs(r.t_memory - byts / (256 * 3.35e12)) < 1e-12
    assert abs(r.t_collective - coll / (256 * 450e9)) < 1e-12
    assert r.bottleneck == bottleneck
    assert 0 < r.roofline_fraction <= 1.0
    t_bound = max(r.t_compute, r.t_memory, r.t_collective)
    assert abs(r.roofline_fraction - (flops / 2) / (256 * 989e12) / t_bound) < 1e-12
    assert abs(r.flops_ratio - 0.5) < 1e-9


def test_row_keys_and_from_counts_on_one_card():
    cfg = tconfigs.get_arch("phi4-mini-3.8b")
    shape = tbase.ShapeSpec("train_8x4k", 4096, 8, "train")
    r = troof.from_counts(cfg, shape, treport.MESH, 1,
                          {"flops": 2e15, "bytes": 4e12}, peak_bytes=64e9)
    assert r.collective_bytes == 0 and r.t_collective == 0
    assert r.model_flops == 6 * cfg.active_param_count() * 8 * 4096
    assert r.hlo_flops == 2e15 and r.hlo_bytes == 4e12 and r.per_device_hbm_bytes == 64e9
    ref = jroof.Roofline(arch="x", shape="s", mesh="m", chips=1, hlo_flops=1, hlo_bytes=1,
                         collective_bytes=0, model_flops=1, per_device_hbm_bytes=1)
    assert list(r.row()) == list(ref.row())
    assert [f.name for f in dataclasses.fields(troof.Roofline)] == [
        f.name for f in dataclasses.fields(jroof.Roofline)]
    assert troof.peak_share(989e12, 2.0) == 0.5


def _rows():
    out = []
    for name, kind, flops, byts in (("phi4-mini-3.8b", "train", 3.1e15, 9e12),
                                    ("zamba2-1.2b", "train", 8.2e14, 5e12),
                                    ("phi4-mini-3.8b", "decode", 3.0e10, 8e9)):
        cfg = tconfigs.get_arch(name)
        shape = tbase.ShapeSpec(f"{kind}_x", 4096, 4, kind)
        r = troof.from_counts(cfg, shape, treport.MESH, 1, {"flops": flops, "bytes": byts}, 30e9)
        out.append({"arch": r.arch, "shape": r.shape, "mesh": r.mesh, "ok": True,
                    "roofline": r.row(), "memory": {"peak_gb": 30.0}})
    return out


def test_report_table_renders_the_references_rows(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows()))
    rows = treport.load(str(path))
    assert rows == jreport.load(str(path))
    got = treport.roofline_table(rows).splitlines()
    want = jreport.roofline_table(rows, treport.MESH).splitlines()
    assert len(got) == 2 + 3 and got[2:] == want[2:]
    assert got[0] == want[0].replace("HLO_FLOPs", "counted FLOPs")
    assert treport.fmt_seconds(1.23e-3) == jreport.fmt_seconds(1.23e-3)


def test_report_main_prints_a_rows_file(tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows()))
    assert treport.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "1xH100" in out and "3 counted steps" in out and out.count("**") == 6
    assert treport.main([]) == 2


def _dryrun_rows():
    """Dry-run records of two cells on both production meshes, one failed."""
    out = []
    for i, (name, kind) in enumerate((("phi4-mini-3.8b", "train"), ("zamba2-1.2b", "decode"))):
        cfg = tconfigs.get_arch(name)
        shape = tbase.ShapeSpec(f"{kind}_x", 4096, 256, kind)
        for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
            if i == 1 and mesh == "2x16x16":
                out.append({"arch": name, "shape": shape.name, "mesh": mesh, "ok": False,
                            "error": "RuntimeError: x"})
                continue
            r = troof.from_counts(cfg, shape, mesh, chips, {"flops": 1e13, "bytes": 4e10,
                                                            "collective_bytes": 3e9}, 20e9)
            out.append({"arch": name, "shape": shape.name, "mesh": mesh, "ok": True,
                        "roofline": r.row(), "memory": {"peak_gb": 20.0 + i},
                        "collective_gb_per_device": 3.0, "compile_s": 12.5})
    return out


def test_dryrun_table_renders_the_references_rows(tmp_path, capsys):
    """``dryrun_table`` and ``main`` on a dry-run rows file: the reference's
    table row for row (its last column is the fake run's seconds, not a
    compile's), then a roofline table per mesh."""
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _dryrun_rows()))
    rows = treport.load(str(path))
    got, want = treport.dryrun_table(rows).splitlines(), jreport.dryrun_table(rows).splitlines()
    assert got[2:] == want[2:] and len(got) == 4
    assert got[0] == want[0].replace("compile s", "fake run s")
    for mesh in ("16x16", "2x16x16"):
        assert treport.roofline_table(rows, mesh).splitlines()[2:] == \
            jreport.roofline_table(rows, mesh).splitlines()[2:]
    assert treport.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "3/4 cells ran" in out and "2x16x16" in out and "1xH100" not in out


def test_count_step_counts_bytes_of_every_op_but_views():
    x = torch.ones(64, 32)
    c = troof.count_step(lambda a: a.view(-1).reshape(32, 64).t() + 1, x)
    assert c["flops"] == 0
    assert c["bytes"] == 2 * x.numel() * 4       # one read, one written
    w = torch.ones(32, 16)
    c = troof.count_step(torch.mm, x, w)
    assert c["flops"] == 2 * 64 * 32 * 16
    assert torch.equal(c["out"], x @ w)


def _dense_counts(cfg, b, s):
    """Analytic matrix-product FLOPs of one dense layer's forward, its MLP
    down projection's, and the LM head's, at (b, s): every (query, KV chunk)
    pair counted, as ``blockwise_attention`` computes them all."""
    d, h, kv, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, cfg.d_ff
    t = -(-s // min(cfg.kv_chunk, s)) * min(cfg.kv_chunk, s)
    layer = (2 * b * s * d * (h * hd + 2 * kv * hd)     # q, k, v
             + 2 * b * s * h * hd * d                   # o
             + 2 * 2 * b * h * s * t * hd               # scores and p @ v
             + 3 * 2 * b * s * d * f)                   # gate, up, down
    return layer, 2 * b * s * f * d, 2 * b * s * d * cfg.vocab_size


@pytest.mark.parametrize("remat", ["none", "group", "block"])
def test_count_step_of_a_dense_train_step_is_the_analytic_count(remat):
    """``loss_fn`` forward and backward: three times the forward's products
    (each backward product gives two), plus what checkpoints recompute.
    The chunked cross-entropy is checkpointed in every mode, so its head
    product runs a fourth time.  PyTorch's checkpoints stop recomputing
    once the last tensor the backward needs is back: a layer's recompute
    skips its MLP down projection, a group's stops at its last layer's
    input; "block" nests each layer's checkpoint in its group's."""
    cfg = dataclasses.replace(tconfigs.get_arch("phi4-mini-3.8b").reduced(), remat=remat)
    assert cfg.family == "dense"
    b, s = 2, 32
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TLM.init_params(cfg, gen, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, tbase.ShapeSpec("smoke", s, b, "train"), 0).items()}
    got = troof.count_step(loss_and_grads, TLM.Model(cfg), params, batch)
    layer, down, head = _dense_counts(cfg, b, s)
    n = cfg.num_layers
    g = TLM._remat_group_size(n)
    want = 3 * (n * layer + head) + head
    if remat == "group":
        want += (n // g) * (g * layer - down)
    elif remat == "block":
        assert n // g > 1
        want += n * (layer - down) + (n // g) * (g - 1) * layer
    np.testing.assert_allclose(got["flops"], want, rtol=1e-2)
    assert got["bytes"] > 0 and np.isfinite(float(got["out"][0]))
