"""Parity of the port's LM training with ``repro``'s: the optimizers
(AdamW with decay, clipping and ``cosine_schedule``; SGD; ``global_norm``;
``apply_updates``), ``make_train_step`` over 8 steps from the same state,
microbatching, checkpoints in the reference's format both ways, the
``Trainer`` (checkpoints, resume, the emergency checkpoint and when it is
not written) and
``launch/train.py``.

Tolerances (the measured worst value beside each): Adam in float32 rtol
1e-6 / atol 1e-7 of each moment and parameter (parameters 2.4e-7 relative,
the first moment 7.2e-6 relative where it is near zero: the same float32
expressions, which XLA fuses), in bf16 bit for bit (equal, the constants
rounded to bf16 as JAX's weakly typed scalars are); the defaults, the SLAM
path's, bit for bit against the expressions the port used before;
``update_apply`` bit for bit against ``update`` and ``apply_updates``; 8
train steps: each step's loss within 3e-2 of the reference's (4.4e-3 phi4,
1.6e-2 xlstm) and both falling by 0.05, the reference's own invariant;
microbatches 1 against 2, the reference's microbatch tolerance: loss rtol
2e-2 (7.1e-8) and parameters atol 3e-2 (2.0e-3); checkpoints and a resumed
run bit for bit.
"""

import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _shared_runs import shared
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import lm as JLM
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro.train.data import synthetic_batch
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as TLM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as TO
from repro_torch.train.data import data_iterator, device_batch
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

SMOKE = jbase.ShapeSpec("smoke", seq_len=32, global_batch=2, kind="train")
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Reduced-size models are thousands of small CPU ops, which a pool of
    intra-op threads only slows, the more so when the test run's other
    workers hold every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _same(a: dict, b: dict) -> bool:
    pa, pb = TO.tree_paths(a), TO.tree_paths(b)
    return pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _opt_tree(seed, dtype):
    r = np.random.default_rng(seed)
    mk = lambda *s: r.normal(size=s).astype(np.float32)
    tree = {"w": mk(6, 5), "nested": {"b": mk(7), "deep": {"c": mk(3, 2, 2)}}, "a": mk(4)}
    if dtype == "bf16":
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    return tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["adam", "adamw-clip", "adamw-clip-cosine"])
def test_adam_matches_the_reference(dtype, kind):
    """Five steps on nested trees (the LM's shape of state) from the same
    parameters, with the reference's update jitted as its trainer runs it."""
    kw = {"adam": dict(lr=3e-2),
          "adamw-clip": dict(lr=3e-2, weight_decay=0.1, clip_norm=0.5),
          "adamw-clip-cosine": dict(weight_decay=0.1, clip_norm=0.5)}[kind]
    jkw, tkw = dict(kw), dict(kw)
    if "cosine" in kind:
        jkw["lr"] = JO.cosine_schedule(3e-2, warmup=2, total=5)
        tkw["lr"] = TO.cosine_schedule(3e-2, warmup=2, total=5)
    jopt, topt = JO.Adam(**jkw), TO.Adam(**tkw)
    p_np = _opt_tree(0, dtype)
    jp, tp = jax.tree.map(jnp.asarray, p_np), convert.lm_params_from_numpy(p_np, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for i in range(5):
        g_np = jax.tree.map(lambda a: (a * 3).astype(a.dtype), _opt_tree(10 + i, dtype))
        ju, js = jstep(jax.tree.map(jnp.asarray, g_np), js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = topt.update(convert.lm_params_from_numpy(g_np, device="cpu"), ts, tp)
        tp = TO.apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == i + 1
        for want, got in ((js.mu, ts.mu), (js.nu, ts.nu), (jp, tp)):
            w, g = TO.tree_paths(jax.device_get(want)), TO.tree_paths(got)
            for k in w:
                assert g[k].dtype == convert._leaf(w[k], "cpu").dtype
                if dtype == "f32":
                    np.testing.assert_allclose(_np(g[k]), _np(w[k]), rtol=1e-6, atol=1e-7)
                else:
                    np.testing.assert_array_equal(_np(g[k]), _np(w[k]))


def _adam_before(opt, grads, state):
    """The port's Adam.update before decay, clipping and nested trees: the
    SLAM path's expressions, which the defaults must keep bit for bit."""
    from repro_torch._device import constant
    step = state.step + 1
    mu = {k: opt.b1 * state.mu[k] + (1 - opt.b1) * g for k, g in grads.items()}
    nu = {k: opt.b2 * state.nu[k] + (1 - opt.b2) * g * g for k, g in grads.items()}
    stepf = step.to(torch.float32)
    bc1 = 1.0 - constant(opt.b1, torch.float32, step.device) ** stepf
    bc2 = 1.0 - constant(opt.b2, torch.float32, step.device) ** stepf
    a = constant(opt.lr, torch.float32, step.device) / bc1
    inv = torch.rsqrt(bc2)
    return ({k: -a * mu[k] / (torch.sqrt(nu[k]) * inv + opt.eps) for k in grads},
            TO.AdamState(step=step, mu=mu, nu=nu))


def test_adam_defaults_keep_the_slam_bits():
    r = np.random.default_rng(3)
    params = {k: torch.from_numpy(r.normal(size=(50, 3)).astype(np.float32))
              for k in ("mu", "log_scale", "color")}
    opt = TO.Adam(lr=1e-3)
    s_new = s_old = opt.init(params)
    for i in range(4):
        grads = {k: torch.from_numpy(r.normal(size=(50, 3)).astype(np.float32) * 10 ** -i)
                 for k in params}
        u_new, s_new = opt.update(grads, s_new)
        u_old, s_old = _adam_before(opt, grads, s_old)
        assert _same(u_new, u_old) and _same(s_new.mu, s_old.mu) and _same(s_new.nu, s_old.nu)
        mask = torch.from_numpy(r.uniform(size=50) > 0.3)
        um, sm = opt.update_masked(grads, s_new, mask)
        assert torch.equal(um["mu"][~mask], torch.zeros_like(um["mu"][~mask]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_update_apply_equals_update_then_apply(dtype):
    opt = TO.Adam(lr=TO.cosine_schedule(1e-2, 1, 4), weight_decay=0.1, clip_norm=0.3)
    p = convert.lm_params_from_numpy(_opt_tree(0, dtype), device="cpu")
    s = opt.init(p)
    p2 = TO.tree_map(torch.clone, p)
    s2 = TO.AdamState(s.step.clone(), TO.tree_map(torch.clone, s.mu), TO.tree_map(torch.clone, s.nu))
    for i in range(3):
        g = convert.lm_params_from_numpy(_opt_tree(20 + i, dtype), device="cpu")
        u, s = opt.update(g, s, p)
        p = TO.apply_updates(p, u)
        g2 = TO.tree_map(torch.clone, g)
        p2, s2, gnorm = opt.update_apply(g2, s2, p2)
        assert g2 == {} and _same(p, p2) and _same(s.mu, s2.mu) and _same(s.nu, s2.nu)
        assert torch.equal(gnorm, TO.global_norm(g))


def test_sgd_global_norm_apply_and_schedule_match():
    p_np, g_np = _opt_tree(1, "f32"), _opt_tree(2, "f32")
    tp, tg = (convert.lm_params_from_numpy(t, device="cpu") for t in (p_np, g_np))
    jp, jg = jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, g_np)
    np.testing.assert_allclose(float(TO.global_norm(tg)), float(JO.global_norm(jg)), rtol=1e-6)
    jopt, topt = JO.SGD(lr=0.1, momentum=0.9), TO.SGD(lr=0.1, momentum=0.9)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        ju, js = jopt.update(jg, js)
        tu, ts = topt.update(tg, ts)
    for k, w in TO.tree_paths(jax.device_get(ju)).items():
        np.testing.assert_allclose(_np(TO.tree_paths(tu)[k]), _np(w), rtol=1e-6)
    bf = {"w": torch.ones(3, dtype=BF16)}
    out = TO.apply_updates(bf, {"w": torch.full((3,), 0.25)})
    assert out["w"].dtype == BF16 and torch.equal(out["w"], torch.full((3,), 1.25, dtype=BF16))
    jlr, tlr = JO.cosine_schedule(1.0, 10, 100, 0.1), TO.cosine_schedule(1.0, 10, 100, 0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(torch.tensor(step, dtype=torch.int32))),
                                   float(jlr(jnp.asarray(step, jnp.int32))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


def _ref_steps(name):
    """The reference's test_loss_decreases run: Adam(lr=3e-3, clip_norm=1),
    8 jitted steps of make_train_step on one batch; its losses."""
    cfg = jconfigs.get_arch(name).reduced()
    model = JLM.Model(cfg)
    params = JLM.init_params(cfg, jax.random.PRNGKey(0))
    opt = JO.Adam(lr=3e-3, clip_norm=1.0)
    step = jax.jit(JT.make_train_step(model, opt, 1))
    batch = synthetic_batch(cfg, SMOKE, 0)
    p0 = jax.device_get(params)
    state = opt.init(params)
    losses = []
    for _ in range(8):
        m, params, state = step(params, state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(m["loss"]))
    return dict(params=p0, batch=batch, losses=losses)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "xlstm-125m"])
def test_train_steps_match_the_reference(name, request, tmp_path_factory):
    run = shared(request, tmp_path_factory, f"torch_train_ref_{name}", lambda: _ref_steps(name))
    cfg = tconfigs.get_arch(name).reduced()
    opt = TO.Adam(lr=3e-3, clip_norm=1.0)
    step = make_train_step(TLM.Model(cfg), opt, 1)
    params = convert.lm_params_from_numpy(run["params"], device="cpu")
    state = opt.init(params)
    batch = device_batch(run["batch"], "cpu")
    losses = []
    for _ in range(8):
        m, params, state = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, run["losses"], atol=3e-2, rtol=0)
    assert losses[-1] < losses[0] - 0.05 and run["losses"][-1] < run["losses"][0] - 0.05


def _fresh(name, batch_size=4):
    cfg = tconfigs.get_arch(name).reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TLM.init_params(cfg, gen, device="cpu")
    batch = device_batch(synthetic_batch(jconfigs.get_arch(name).reduced(),
                                         jbase.ShapeSpec("s", 32, batch_size, "train"), 0), "cpu")
    return cfg, params, batch


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_microbatched_step_matches_plain(compression):
    """The reference's invariant (tests/test_models.py): one step with 2
    microbatches within rtol 2e-2 (loss) and atol 3e-2 (parameters) of the
    same step in one batch; accumulation in the parameters' dtype."""
    cfg, params, batch = _fresh("phi4-mini-3.8b")
    opt = TO.Adam(lr=1e-3)
    out = {}
    for mb in (1, 2):
        p = TO.tree_map(torch.clone, params)
        m, p, _ = make_train_step(TLM.Model(cfg), opt, mb, compression)(p, opt.init(p), batch)
        out[mb] = (float(m["loss"]), p)
    np.testing.assert_allclose(out[1][0], out[2][0], rtol=2e-2)
    for k, a in TO.tree_paths(out[1][1]).items():
        b = TO.tree_paths(out[2][1])[k]
        assert a.dtype == b.dtype
        np.testing.assert_allclose(_np(a), _np(b), atol=3e-2)


def test_train_step_consumes_its_inputs_and_keeps_dtypes():
    cfg, params, batch = _fresh("qwen3-moe-30b-a3b", 2)
    dtypes = {k: v.dtype for k, v in TO.tree_paths(params).items()}
    opt = TO.Adam(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    state = opt.init(params)
    m, new, state = make_train_step(TLM.Model(cfg), opt)(params, state, batch)
    assert new is params and int(state.step) == 1
    assert {k: v.dtype for k, v in TO.tree_paths(new).items()} == dtypes
    assert {k: v.dtype for k, v in TO.tree_paths(state.mu).items()} == dtypes
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


# ---------------------------------------------------------------------------
# checkpoints in the reference's format
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_state():
    """A reference train state after one AdamW step (bf16 and float32
    leaves, the () int32 step, the Python step); callers do not mutate it."""
    cfg = jconfigs.get_arch("zamba2-1.2b").reduced()
    params = JLM.init_params(cfg, jax.random.PRNGKey(1))
    opt = JO.Adam(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    grads = jax.tree.map(lambda p: (p * 0.5).astype(p.dtype), params)
    upd, st = jax.jit(opt.update)(grads, opt.init(params), params)
    return {"params": jax.jit(JO.apply_updates)(params, upd), "opt": st, "step": 3}


def _assert_state_equal(port, ref):
    assert port["step"] == int(ref["step"]) and isinstance(port["step"], int)
    rp = jax.device_get(ref["params"])
    ro = jax.device_get(ref["opt"])
    assert _same(port["params"], convert.lm_params_from_numpy(rp, device="cpu"))
    want = convert.lm_adam_from_numpy(ro, device="cpu")
    assert torch.equal(port["opt"].step, want.step) and port["opt"].step.dtype == torch.int32
    assert _same(port["opt"].mu, want.mu) and _same(port["opt"].nu, want.nu)


def test_checkpoint_manifest_is_the_references(tmp_path):
    """The same state saved by both packages: the same manifest (paths,
    files, dtypes, shapes) and the same bytes in every leaf file."""
    ref = _ref_state()
    port = convert.lm_train_state_from_numpy(jax.device_get(ref), device="cpu")
    jdir = jckpt.save(str(tmp_path / "j"), ref)
    tdir = tckpt.save(str(tmp_path / "t"), port)
    mj = json.load(open(os.path.join(jdir, "manifest.json")))
    mt = json.load(open(os.path.join(tdir, "manifest.json")))
    assert mt == mj
    assert [l["path"] for l in mt["leaves"]][:2] == ["opt/.step", "opt/.mu/embed"]
    assert mt["leaves"][-1]["path"] == "step"
    for leaf in mt["leaves"]:
        a, b = (np.load(os.path.join(d, leaf["file"])) for d in (jdir, tdir))
        assert a.dtype == b.dtype and np.array_equal(a, b), leaf["path"]


@pytest.mark.parametrize("with_template", [True, False])
def test_checkpoints_cross_between_the_packages(tmp_path, with_template):
    ref = _ref_state()
    # the reference's checkpoint, restored by the port
    jckpt.save(str(tmp_path / "j"), ref)
    if with_template:
        template = Trainer(tconfigs.get_arch("zamba2-1.2b").reduced(), TrainerConfig(),
                           iter(()), device="cpu").init_state(device="meta")
        got = tckpt.restore(str(tmp_path / "j"), template=template, device="cpu")
        assert isinstance(got["opt"], TO.AdamState)
        _assert_state_equal(got, ref)
    else:
        got = tckpt.restore(str(tmp_path / "j"), device="cpu")
        want = jckpt.restore(str(tmp_path / "j"))
        assert set(got["opt"]) == set(want["opt"]) == {".step", ".mu", ".nu"}
        gp, wp = TO.tree_paths(got), TO.tree_paths(want)
        assert gp.keys() == wp.keys()
        for k in gp:
            assert np.array_equal(_np(gp[k]), np.asarray(wp[k], np.float32)), k
    # the port's checkpoint, restored by the reference
    port = convert.lm_train_state_from_numpy(jax.device_get(ref), device="cpu")
    tckpt.save(str(tmp_path / "t"), port)
    template = jax.eval_shape(lambda: ref) if with_template else None
    back = jckpt.restore(str(tmp_path / "t"), template=template)
    if with_template:
        assert isinstance(back["opt"], JO.AdamState)
        _assert_state_equal(port, back)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert back["step"] == 3 and set(back["opt"]) == {".step", ".mu", ".nu"}


def test_checkpoint_atomic_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3),
                        "nested": {"b": torch.ones(4, dtype=BF16)}},
             "opt": (torch.zeros(()), {"m": torch.full((2, 3), 0.5)}), "step": 7}
    tckpt.save(d, state)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    assert tckpt.latest_step(d) == 7
    state["step"] = 12
    tckpt.save(d, state)
    assert tckpt.latest_step(d) == 12
    old = tckpt.restore(d, step=7, device="cpu")
    assert old["step"] == 7 and old["params"]["nested"]["b"].dtype == BF16
    assert isinstance(old["opt"], tuple) and torch.equal(old["opt"][1]["m"], state["opt"][1]["m"])
    with pytest.raises(ValueError, match="not in the template"):
        tckpt.restore(d, template={"params": state["params"], "step": 0}, device="cpu")


def test_lm_adam_from_numpy_keeps_the_bits():
    ref = jax.device_get(_ref_state())
    got = convert.lm_adam_from_numpy(ref["opt"], device="cpu")
    assert got.step.dtype == torch.int32 and got.step.shape == () and int(got.step) == 1
    for k, w in TO.tree_paths(ref["opt"].mu).items():
        g = TO.tree_paths(got.mu)[k]
        want = np.asarray(w)
        have = g.view(torch.int16).numpy().view(np.uint16) if g.dtype == BF16 else g.numpy()
        assert np.array_equal(have, want.view(np.uint16) if want.dtype.name == "bfloat16"
                              else want), k


# ---------------------------------------------------------------------------
# the Trainer and launch/train.py
# ---------------------------------------------------------------------------


def _trainer(ckpt, steps=4, ckpt_every=2, start=0):
    cfg = tconfigs.get_arch("xlstm-125m").reduced()
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt),
                         lr=1e-3, log_every=100)
    data = data_iterator(cfg, ShapeSpec("smoke", 32, 2, "train"), seed=0, start_step=start)
    return Trainer(cfg, tcfg, data, device="cpu")


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _trainer(tmp_path / "ck")
    final = tr.run()
    assert final["step"] == 4 and tckpt.latest_step(str(tmp_path / "ck")) == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002", "step_00000004"]
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in tr.history)
    assert len(tr.step_times) == 4 and tr.straggler_events == []
    back = tckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert _same(back["params"], final["params"])


def test_trainer_resume_is_bit_equal(tmp_path):
    """4 straight steps == 2 steps + restart (crash resume from the latest
    checkpoint, the data stream seeked to step 2) + 2 steps."""
    end_a = _trainer(tmp_path / "a", steps=4, ckpt_every=10).run()
    _trainer(tmp_path / "b", steps=2, ckpt_every=2).run()
    tr_b = _trainer(tmp_path / "b", steps=4, ckpt_every=10, start=2)
    end_b = tr_b.run()
    assert [h["step"] for h in tr_b.history] == [2, 3]
    assert _same(end_a["params"], end_b["params"])
    assert _same(end_a["opt"].mu, end_b["opt"].mu) and torch.equal(end_a["opt"].step,
                                                                    end_b["opt"].step)


def test_trainer_emergency_checkpoint(tmp_path):
    tr = _trainer(tmp_path / "ck", steps=4, ckpt_every=100)
    calls = {"n": 0}
    orig = tr.step_fn

    def bomb(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected node failure")
        return orig(*args)

    tr.step_fn = bomb
    with pytest.raises(RuntimeError, match="injected"):
        tr.run()
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2


def test_trainer_saves_nothing_when_the_update_fails_part_way(tmp_path, monkeypatch):
    """A failure inside ``update_apply`` leaves some leaves at the new step
    and the others at the old one: it surfaces as ``UpdateInterrupted`` and
    no emergency checkpoint is written, so a restart resumes from the last
    whole one."""
    tr = _trainer(tmp_path / "ck", steps=4, ckpt_every=2)
    n_leaves = len(TO.tree_leaves(tr.init_state(device="meta")["params"]))
    calls = {"n": 0}
    real = TO.Adam._leaf

    def leaf(self, *args):
        calls["n"] += 1
        if calls["n"] == 2 * n_leaves + 3:      # step 2's third leaf
            raise RuntimeError("injected out of memory")
        return real(self, *args)

    monkeypatch.setattr(TO.Adam, "_leaf", leaf)
    with pytest.raises(TO.UpdateInterrupted) as err:
        tr.run()
    monkeypatch.undo()
    assert "injected" in str(err.value.__cause__)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]
    # the periodic checkpoint is left as it was: two whole steps
    whole = _trainer(tmp_path / "ref", steps=2, ckpt_every=100).run()
    back = tckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert _same(back["params"], whole["params"]) and _same(back["opt"][".mu"], whole["opt"].mu)


def test_trainer_emergency_checkpoint_when_the_first_leaf_fails(tmp_path, monkeypatch):
    """A failure in the update's first leaf, before anything is written,
    raises as it came; the Trainer then saves the whole state under the
    step it stands at, as the reference saves on any failure of a step,
    and that checkpoint loads and equals the state of a run one step long."""
    tr = _trainer(tmp_path / "ck", steps=4, ckpt_every=100)
    n_leaves = len(TO.tree_leaves(tr.init_state(device="meta")["params"]))
    calls = {"n": 0}
    real = TO.Adam._leaf

    def leaf(self, *args):
        calls["n"] += 1
        if calls["n"] == n_leaves + 1:          # step 2's first leaf
            raise RuntimeError("injected out of memory")
        return real(self, *args)

    monkeypatch.setattr(TO.Adam, "_leaf", leaf)
    with pytest.raises(RuntimeError, match="injected") as err:
        tr.run()
    monkeypatch.undo()
    assert not isinstance(err.value, TO.UpdateInterrupted)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001"]
    whole = _trainer(tmp_path / "ref", steps=1, ckpt_every=100).run()
    back = tckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert back["step"] == 1 and torch.equal(back["opt"][".step"], whole["opt"].step)
    assert _same(back["params"], whole["params"])
    assert _same(back["opt"][".mu"], whole["opt"].mu)
    assert _same(back["opt"][".nu"], whole["opt"].nu)


def test_update_apply_first_leaf_failure_leaves_every_tree_whole(monkeypatch):
    """``update_apply`` failing at its first leaf writes nothing: the
    parameters, both moments and the gradient tree are as they were."""
    opt = TO.Adam(lr=1e-2, weight_decay=0.01, clip_norm=1.0)
    r = np.random.default_rng(3)
    params = {"a": {"w": torch.from_numpy(r.normal(size=(3, 4)).astype(np.float32))},
              "b": torch.from_numpy(r.normal(size=(5,)).astype(np.float32))}
    grads = TO.tree_map(lambda p: torch.full_like(p, 0.5), params)
    state = opt.update(grads, opt.init(params), params)[1]
    before = (TO.tree_map(torch.clone, params), TO.tree_map(torch.clone, state.mu),
              TO.tree_map(torch.clone, state.nu), TO.tree_map(torch.clone, grads))

    def boom(self, *args):
        raise RuntimeError("injected")

    monkeypatch.setattr(TO.Adam, "_leaf", boom)
    with pytest.raises(RuntimeError, match="injected") as err:
        opt.update_apply(grads, state, params)
    assert not isinstance(err.value, TO.UpdateInterrupted)
    for got, want in zip((params, state.mu, state.nu, grads), before):
        assert _same(got, want)


def test_trainer_emergency_checkpoint_after_the_update(tmp_path):
    """A failure after the step returned (reading its metrics) saves the
    new state under the next step's number."""
    tr = _trainer(tmp_path / "ck", steps=4, ckpt_every=100)
    orig, seen = tr.step_fn, {}

    def bad_metrics(*args):
        metrics, params, opt_state = orig(*args)
        if int(opt_state.step) == 3:
            seen.update(params=TO.tree_map(torch.clone, params), step=opt_state.step.clone())
            metrics = dict(metrics, broken="not a tensor")
        return metrics, params, opt_state

    tr.step_fn = bad_metrics
    with pytest.raises(TypeError):
        tr.run()
    assert tckpt.latest_step(str(tmp_path / "ck")) == 3
    back = tckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert _same(back["params"], seen["params"]) and torch.equal(back["opt"][".step"],
                                                                 seen["step"])


def test_trainer_matches_the_reference_trainer_start(tmp_path):
    """The reference Trainer and the port's, from the same parameters (a
    state handed to ``run``) and data: the same history within the train
    steps' tolerance."""
    jcfg = jconfigs.get_arch("xlstm-125m").reduced()
    jtr = JT.Trainer(jcfg, JT.TrainerConfig(steps=3, lr=1e-3, log_every=100),
                     (synthetic_batch(jcfg, SMOKE, 0, 0) for _ in itertools.count()))
    jstate = jtr.init_state()
    port_state = convert.lm_train_state_from_numpy(jax.device_get(jstate), device="cpu")
    jtr.run(state=jstate)
    ttr = _trainer(tmp_path / "ck", steps=3)
    ttr.tcfg.ckpt_dir = None
    ttr.data_iter = (synthetic_batch(jcfg, SMOKE, 0, 0) for _ in itertools.count())
    ttr.run(state=port_state)
    np.testing.assert_allclose([h["loss"] for h in ttr.history],
                               [h["loss"] for h in jtr.history], atol=3e-2)


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    tr = tlaunch.main(["--arch", "xlstm-125m", "--device", "cpu", "--steps", "3",
                       "--seq-len", "32", "--batch", "2", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out)])
    text = capsys.readouterr().out
    assert "step     2 loss" in text and "done: 3 steps" in text
    assert len(json.loads(out.read_text())) == 3 and tr.cfg.microbatches == 1
    assert tckpt.latest_step(str(tmp_path / "ck")) == 3
    assert all(p.device.type == "cpu" for p in TO.tree_leaves(
        tckpt.restore(str(tmp_path / "ck"), device="cpu")["params"]))


def test_launch_train_and_trainer_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "xlstm-125m", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tconfigs.get_arch("xlstm-125m").reduced(), TrainerConfig(), iter(()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore("/nonexistent")
