"""Sharded LM training and decoding (``launch/dryrun.build_case``,
``models/sharded.py``, ``make_train_step``'s ``microbatch_specs`` /
``grad_specs``) on eight gloo CPU ranks, held to the one-rank run of the
port on the same inputs (the one-rank run is held to the reference by
``test_torch_lm*.py`` and ``test_torch_train.py``).

The ranks are ``tests/_dist_ranks.py``'s one shared launch
(``test_torch_distributed.py`` starts it the same way; no test process
starts a process group).  They run:

  * the reference's mini dry-run (``tests/test_multidevice.py``'s
    ``test_mini_dryrun_train_and_decode``) for real: qwen3-moe-30b-a3b,
    zamba2-1.2b and whisper-large-v3 at ``reduced()`` with two microbatches
    on a (2, 4) ("data", "model") mesh, the train step at (64, 8), and the
    prefill and two decode steps at (64, 8); then six decode steps from a
    drawn cache whose live slots lie on every "model" rank, past the
    ring's end;
  * the same train step for the other seven architectures, so each
    family's sharding roles run once (FSDP+TP, the VLM, TP only, MoE with
    FSDP experts, pure DP);
  * the gradient sync's bytes for xlstm-125m on an (8,) data mesh, with
    bf16 compression and with the cast after the sync;
  * reduced phi4's train step on a (4, 2) mesh, whose 4 data ranks do not
    divide its 2 microbatches (the batch split's all-to-all).

Bounds.  With the batch sharded over "data" alone the sharded step
changes only the order of batch sums (float32 loss within 1e-5, bf16
gradients within 2^-6 of their leaf's largest entry, float32 ones within
1e-5 relative L2).  Where the model axis splits heads, FFN columns or
experts, each row-parallel product is a float32 sum over "model" rounded
once to bf16, where one rank rounds a bf16 GEMM: about 3e-4 of those
outputs land one bf16 ulp apart, and four layers carry that into the loss
at ~1e-5.  The one-rank run moves as much on its own when only its
row-parallel products are rounded from float32
(``test_row_parallel_rounding_moves_the_one_rank_run``), so runs that
split over "model" are held to: loss rtol 1e-4, bf16 gradients 2^-5 of
their leaf's largest entry, float32 gradients 2e-2 relative L2, and
whisper's prefill logits to 7e-2 (its card-against-CPU bound, a change of
summation order too).  Grad norm rtol 1e-3, parameters after the step atol
3e-2, logits 3e-2 and cache leaves 3e-2 of their largest magnitude hold
for every run.
"""

import math

import numpy as np
import pytest
import torch

import _dist_ranks as R
from _shared_runs import shared
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as TLM
from repro_torch.models.layers import silu
from repro_torch.train.optimizer import Adam, tree_paths
from repro_torch.train.trainer import make_train_step

ARCHS = R.DRYRUN_FULL + R.DRYRUN_TRAIN
MESH_2x4 = Mesh(("data", "model"), np.arange(8).reshape(2, 4), "cpu")

LOSS_RTOL = {"data": 1e-5, "model": 1e-4}
BF16_GRAD = {"data": 2.0 ** -6, "model": 2.0 ** -5}
F32_GRAD = {"data": 1e-5, "model": 2e-2}
GNORM_RTOL, PARAM_ATOL, LOGIT_ATOL, CACHE_REL = 1e-3, 3e-2, 3e-2, 3e-2
WHISPER_PREFILL_ATOL = 7e-2


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_dist_ranks",
                  lambda: R.spawn(tmp_path_factory.mktemp("gloo")))


def _case(ranks, name) -> list:
    for r, res in enumerate(ranks):
        assert "error" not in res[name], f"rank {r}:\n{res[name].get('error')}"
    return [res[name] for res in ranks]


def _np(t):
    return t.detach().float().numpy()


def _split_over_model(results) -> bool:
    """Whether any parameter of the run is split over "model" (S on the
    mesh's second axis)."""
    return any(p[1].startswith("S") for p in results["param_placements"].values())


def _one_rank_train(name):
    """The port's one-rank step on the inputs ``build_case`` draws, in its
    two halves: (gradients, metrics, parameters after, input sums)."""
    cfg = R.dryrun_cfg(name)
    params, opt_state = dryrun.abstract_state(cfg, True, "cpu", 0)
    sums = {k: float(v.double().sum()) for k, v in tree_paths(params).items()}
    batch = dryrun.draw_inputs(cfg, R.DRYRUN_TRAIN_SHAPE, "cpu", 0)
    pure_dp = cfg.pure_dp and R.DRYRUN_TRAIN_SHAPE.global_batch % 8 == 0
    mb = dryrun.microbatch_count(cfg, R.DRYRUN_TRAIN_SHAPE, 8 if pure_dp else 2)
    step = make_train_step(TLM.Model(cfg), Adam(lr=1e-4, weight_decay=0.01, clip_norm=1.0), mb)
    loss, grads = step.grads(params, batch)
    kept = {k: g.clone() for k, g in tree_paths(grads).items()}
    metrics, params, _ = step.apply(loss, grads, params, opt_state)
    return kept, metrics, params, sums


@pytest.mark.parametrize("name", ARCHS)
def test_gloo_build_case_train_matches_one_rank(ranks, name):
    """``build_case``'s train step (two microbatches, ``microbatch_specs``,
    ``grad_specs``, AdamW with clipping) against the one-rank step."""
    res = _case(ranks, "dryrun")[0][name]["train"]
    grads, metrics, params, sums = _one_rank_train(name)
    assert res["input_sums"] == sums
    np.testing.assert_array_equal(res["batch"]["tokens"],
                                  _np(dryrun.draw_inputs(R.dryrun_cfg(name),
                                                         R.DRYRUN_TRAIN_SHAPE, "cpu")["tokens"]))
    axis = "model" if _split_over_model(res) else "data"
    loss = float(metrics["loss"])
    assert abs(res["loss"] - loss) <= LOSS_RTOL[axis] * abs(loss)
    assert abs(res["grad_norm"] - float(metrics["grad_norm"])) <= \
        GNORM_RTOL * float(metrics["grad_norm"])
    got = tree_paths(res["grads"])
    for k, g in grads.items():
        want = _np(g)
        assert res["grad_dtypes"][k] == str(g.dtype), k
        if g.dtype == torch.bfloat16:
            assert np.abs(got[k] - want).max() <= BF16_GRAD[axis] * np.abs(want).max(), k
        else:
            assert np.linalg.norm(got[k] - want) <= F32_GRAD[axis] * np.linalg.norm(want), k
    after = tree_paths(res["params"])
    for k, p in tree_paths(params).items():
        np.testing.assert_allclose(after[k], _np(p), atol=PARAM_ATOL, rtol=0, err_msg=k)
        assert res["after_placements"][k] == res["param_placements"][k], k
    assert res["opt_step"] == 1


@pytest.mark.parametrize("name", ARCHS)
def test_gloo_gradients_leave_the_step_on_the_specs(ranks, name):
    """Every gradient is synced onto its parameter's spec: a leaf whose spec
    names "data" (FSDP) leaves as ``Shard`` on "data" (a reduce-scatter onto
    the shard), never ``Replicate`` or ``Partial``."""
    cfg = R.dryrun_cfg(name)
    meta = TLM.init_params(cfg, torch.Generator(), device="meta")
    specs = tree_paths(S.param_specs(cfg, meta, MESH_2x4))
    n_fsdp = 0
    for res in _case(ranks, "dryrun"):
        r = res[name]["train"]
        for k, spec in specs.items():
            want = tuple(str(p) for p in S.placements(("data", "model"), spec))
            assert r["grad_placements"][k] == r["param_placements"][k] == want, k
            n_fsdp += "data" in spec
    assert (n_fsdp > 0) == cfg.fsdp


def test_gloo_fsdp_really_shards_llama3(ranks):
    """llama3-405b at reduced size on (2, 4): each rank's parameter and Adam
    moment bytes are, leaf by leaf, what the specs imply, and under a
    quarter of the whole."""
    cfg = R.dryrun_cfg("llama3-405b")
    meta = TLM.init_params(cfg, torch.Generator(), device="meta")
    specs = tree_paths(S.param_specs(cfg, meta, MESH_2x4))
    leaves = tree_paths(meta)
    whole = sum(t.numel() * t.element_size() for t in leaves.values())
    sizes = {"data": 2, "model": 4}
    for res in _case(ranks, "dryrun"):
        r = res["llama3-405b"]["train"]
        for k, t in leaves.items():
            split = math.prod(sizes[a] for e in specs[k] if e is not None
                              for a in ((e,) if isinstance(e, str) else e))
            want = t.numel() * t.element_size() // split
            assert r["param_bytes"][k] == r["mu_bytes"][k] == r["nu_bytes"][k] == want, k
        assert 4 * sum(r["param_bytes"].values()) < whole


def test_gloo_split_gives_each_microbatch_the_reference_rows(ranks):
    """On a (4, 2) mesh 4 data ranks share 2 microbatches, which DTensor
    cannot unflatten: ``_split_batch`` moves the rows by one all-to-all, and
    microbatch i holds rows [4i, 4i + 4) of the batch, the reference's
    reshape, sharded over "data"."""
    results = _case(ranks, "split")
    res = results[0]
    tokens = _np(dryrun.draw_inputs(R.dryrun_cfg(R.SPLIT_ARCH), R.DRYRUN_TRAIN_SHAPE,
                                    "cpu")["tokens"])
    want = tokens.reshape(2, 4, -1)
    for i, mb in enumerate(res["microbatches"]):
        np.testing.assert_array_equal(mb["tokens"], want[i])
    for r in results:
        assert r["placements"] == [{"tokens": ("S(0)", "R")}] * 2


def test_gloo_split_train_matches_one_rank(ranks):
    """The (4, 2) mesh's train step against the one-rank step, within the
    bounds of runs split over "model" (reduced phi4's 4 heads split over 2
    ranks)."""
    res = _case(ranks, "split")[0]
    _, metrics, params, _ = _one_rank_train(R.SPLIT_ARCH)
    assert _split_over_model(res)
    loss = float(metrics["loss"])
    assert abs(res["loss"] - loss) <= LOSS_RTOL["model"] * abs(loss)
    assert abs(res["grad_norm"] - float(metrics["grad_norm"])) <= \
        GNORM_RTOL * float(metrics["grad_norm"])
    after = tree_paths(res["params"])
    for k, p in tree_paths(params).items():
        np.testing.assert_allclose(after[k], _np(p), atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", R.DRYRUN_FULL)
def test_gloo_build_case_prefill_matches_one_rank(ranks, name):
    """``build_case``'s prefill at the mini dry-run's decode shape: logits
    sharded on "data", every cache leaf against the one-rank prefill."""
    res = _case(ranks, "dryrun")[0][name]["prefill"]
    cfg = R.dryrun_cfg(name)
    params, _ = dryrun.abstract_state(cfg, False, "cpu", 0)
    shape = R.DRYRUN_DECODE_SHAPE
    batch = dryrun.draw_inputs(cfg, ShapeSpec("d", shape.seq_len, shape.global_batch,
                                              "prefill"), "cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(res["batch"][k], _np(v))
    logits, cache = TLM.Model(cfg).prefill(params, batch)
    assert res["logits_placements"] == ("S(0)", "R")
    atol = WHISPER_PREFILL_ATOL if name == "whisper-large-v3" else LOGIT_ATOL
    np.testing.assert_allclose(res["logits"], _np(logits), atol=atol, rtol=0)
    got = tree_paths(res["cache"])
    for k, v in tree_paths(cache).items():
        want = _np(v)
        assert np.abs(got[k] - want).max() <= CACHE_REL * max(np.abs(want).max(), 1.0), k


@pytest.mark.parametrize("name", R.DRYRUN_FULL)
def test_gloo_build_case_decode_matches_one_rank(ranks, name):
    """``build_case``'s decode step, twice from its zero cache (the second
    step reads the first one's ring writes and states), the cache on
    ``cache_specs`` in and out."""
    results = _case(ranks, "dryrun")
    res = results[0][name]["decode"]
    cfg = R.dryrun_cfg(name)
    model = TLM.Model(cfg)
    params, _ = dryrun.abstract_state(cfg, False, "cpu", 0)
    cache = model.cache_struct(R.DRYRUN_DECODE_SHAPE.global_batch,
                               R.DRYRUN_DECODE_SHAPE.seq_len, device="cpu")
    specs = tree_paths(S.cache_specs(cfg, cache, MESH_2x4))
    tokens = dryrun.draw_inputs(cfg, R.DRYRUN_DECODE_SHAPE, "cpu")["tokens"]
    for i, st in enumerate(res["steps"]):
        logits, cache = model.decode_step(params, cache, tokens)
        np.testing.assert_allclose(st["logits"], _np(logits), atol=LOGIT_ATOL, rtol=0)
        got = tree_paths(st["cache"])
        for k, v in tree_paths(cache).items():
            want = _np(v)
            assert np.abs(got[k] - want).max() <= CACHE_REL * max(np.abs(want).max(), 1.0), k
            for r in results:
                placed = r[name]["decode"]["steps"][i]["cache_placements"][k]
                assert placed == tuple(str(p) for p in S.placements(("data", "model"), specs[k]))
        tokens = torch.argmax(logits, -1).to(torch.int32)
    np.testing.assert_array_equal(res["tokens"], _np(tokens))


@pytest.mark.parametrize("name", R.DRYRUN_FULL)
def test_gloo_decode_over_every_ranks_slots_matches_one_rank(ranks, name):
    """``build_case``'s decode step from a drawn cache filled to 60 slots
    (``_dist_ranks.filled_cache``), six steps: every "model" rank holds live
    slots, so four ranks' partial softmaxes combine (whisper's cross
    attention over its drawn K/V too), and the steps write slots held by
    rank 3 and then, past the ring's end, by rank 0."""
    res = _case(ranks, "dryrun")[0][name]["decode_filled"]
    cfg = R.dryrun_cfg(name)
    model = TLM.Model(cfg)
    params, _ = dryrun.abstract_state(cfg, False, "cpu", 0)
    cache = R.filled_cache(cfg)
    written = range(R.FILLED_LEN, R.FILLED_LEN + R.FILLED_STEPS)
    for k, v in tree_paths(cache).items():
        if k.rsplit("/", 1)[-1] == "k":
            t = v.shape[-3]
            assert R.FILLED_LEN >= t * 3 // 4 and {p % t // (t // 4) for p in written} == {0, 3}
    tokens = dryrun.draw_inputs(cfg, R.DRYRUN_DECODE_SHAPE, "cpu")["tokens"]
    assert len(res["steps"]) == R.FILLED_STEPS
    for st in res["steps"]:
        logits, cache = model.decode_step(params, cache, tokens)
        np.testing.assert_allclose(st["logits"], _np(logits), atol=LOGIT_ATOL, rtol=0)
        got = tree_paths(st["cache"])
        for k, v in tree_paths(cache).items():
            want = _np(v)
            assert np.abs(got[k] - want).max() <= CACHE_REL * max(np.abs(want).max(), 1.0), k
        tokens = torch.argmax(logits, -1).to(torch.int32)
    np.testing.assert_array_equal(res["tokens"], _np(tokens))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "whisper-large-v3", "xlstm-125m"])
def test_input_specs_describe_the_drawn_inputs(name, kind):
    """``input_specs`` (the reference's ``ShapeDtypeStruct`` stand-ins, as
    ``meta`` tensors) has the keys, shapes and dtypes of the inputs
    ``build_case`` draws, the VLM's patches and whisper's frames
    included."""
    cfg = R.dryrun_cfg(name)
    shape = ShapeSpec("s", 64, 8, kind)
    specs = dryrun.input_specs(cfg, shape)
    drawn = dryrun.draw_inputs(cfg, shape, "cpu")
    assert sorted(specs) == sorted(drawn)
    for k, v in specs.items():
        assert v.device.type == "meta"
        assert (v.shape, v.dtype) == (drawn[k].shape, drawn[k].dtype), k
    seq = 1 if kind == "decode" else 64 - (cfg.patch_tokens if cfg.family == "vlm" else 0)
    assert tuple(specs["tokens"].shape) == (8, seq)


def test_gloo_gradient_sync_rides_bf16(ranks):
    """The reference's ``test_gradient_sync_rides_bf16``: xlstm-125m with
    ``fsdp=False`` on an (8,) data mesh, batch (8, 32).  With
    ``grad_compression="bf16"`` one step's collectives carry more than 0
    and at most 1.5x the bf16 parameter bytes; the same step casting after
    the sync (float32 on the wire) carries more."""
    for res in _case(ranks, "wire"):
        param_bytes = res["bf16"]["param_bytes"]
        sent = sum(n for _, n in res["bf16"]["ops"])
        assert 0 < sent <= 1.5 * param_bytes, (sent, param_bytes)
        mutant = sum(n for _, n in res["cast_after_sync"]["ops"])
        assert mutant > 1.5 * param_bytes, (mutant, param_bytes)


def test_gloo_census_equals_the_fake_groups(ranks, tmp_path):
    """The same xlstm step (bf16 compression, an (8,) data mesh) on rank 0
    of a fake 8-rank group, started and destroyed here: its collective
    census equals every gloo rank's, kind by kind and byte for byte, and
    its all-reduce bytes are the bf16 parameter bytes (1.00x) and
    two float32 scalars (the loss's token count and sum)."""
    with dryrun.fake_group(R.WORLD):
        fake = R.case_wire(None, str(tmp_path))
    assert not torch.distributed.is_initialized()
    for what in ("bf16", "cast_after_sync"):
        for res in _case(ranks, "wire"):
            assert res[what]["stats"] == fake[what]["stats"], what
    stats, param_bytes = fake["bf16"]["stats"], fake["bf16"]["param_bytes"]
    assert set(stats) == {"all-reduce"}
    assert stats["all-reduce"]["bytes"] == param_bytes + 2 * 4
    assert fake["cast_after_sync"]["stats"]["all-reduce"]["bytes"] == 2 * param_bytes + 2 * 4


def test_row_parallel_rounding_moves_the_one_rank_run():
    """The yardstick of the bounds on runs split over "model": llama3-405b's
    one-rank loss moves by more than 1e-5 (relative) when its row-parallel
    products (attention output and SwiGLU down projections) are float32
    products rounded once, as a sum over "model" gives them."""
    cfg = R.dryrun_cfg("llama3-405b")
    params, _ = dryrun.abstract_state(cfg, True, "cpu", 0)
    batch = dryrun.draw_inputs(cfg, R.DRYRUN_TRAIN_SHAPE, "cpu", 0)
    model = TLM.Model(cfg)
    with torch.no_grad():
        plain = float(model.loss_fn(params, batch))

    def out(o, w, cfg):
        b, s, hl, hd = o.shape
        return (o.reshape(b, s, hl * hd).float() @ w.float()).to(o.dtype)

    def mlp(x, p, cfg):
        xn = TLM._norm(x, p["ln2"], cfg)
        h = silu(xn @ p["wg"]) * (xn @ p["wu"])
        return TLM._residual(x, (h.float() @ p["wd"].float()).to(h.dtype))

    mp = pytest.MonkeyPatch()
    mp.setattr(TLM, "_out", out)
    mp.setattr(TLM, "_mlp_seq", mlp)
    try:
        with torch.no_grad():
            rounded = float(model.loss_fn(params, batch))
    finally:
        mp.undo()
    assert abs(rounded - plain) > LOSS_RTOL["data"] * abs(plain)
    assert abs(rounded - plain) <= LOSS_RTOL["model"] * abs(plain)
