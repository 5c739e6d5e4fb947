"""The port's learned II guidance (``repro_torch.core.guide``) against the
JAX package's: the numpy guide (suggestions, sanitisation, ``span_from``,
registry, ``.npz`` checkpoints read by either package), the soundness
contract in the port's sweep (guided II == unguided II == the reference's
II at widths 1 and 4, with a random and an adversarial guide), and torch
training held to jax/optax: one step's loss and gradients, 20 Adam steps
fed the same batches, and held-out hit@1 on synthetic records."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from repro.core import guide as ref_guide
from repro.core import suite as ref_suite
from repro.core.campaign import CellRecord as RefCellRecord
from repro.core.cgra import CGRA as RefCGRA
from repro.core.mapper import MapperConfig as RefConfig
from repro.core.mapper import map_loop as ref_map_loop
import repro_torch
from repro_torch import MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.campaign import N_FEATURES, CellRecord, cell_features
from repro_torch.core.cgra import CGRA
from repro_torch.core.dfg import running_example
from repro_torch.core.guide import (MAX_GUIDED_SPAN, N_OFFSETS,
                                    GuideSuggestion, IIGuide, _dataset_arrays,
                                    _epoch_perms, _fit, _loss, _mlp,
                                    clear_guides, init_guide, register_guide,
                                    resolve_guide, train_guide)
from repro_torch.core.mapper import MapperConfig, map_loop
from repro_torch.core.service import MappingService

repro_torch.set_default_device("cpu")

CFG = MapperConfig(solver="auto", timeout_s=90)
TRAINED = ("w1", "b1", "wo", "bo", "wh", "bh")


@pytest.fixture(autouse=True)
def _clean_registry():
    clear_guides()
    ref_guide.clear_guides()
    yield
    clear_guides()
    ref_guide.clear_guides()


# ------------------------------------------------------------- numpy guide

def test_guide_save_load_roundtrip(tmp_path):
    g = init_guide(seed=7)
    x = np.arange(N_FEATURES, dtype=np.float32)
    path = str(tmp_path / "g.npz")
    g.save(path)
    g2 = IIGuide.load(path)
    p1, h1 = g.predict(x)
    p2, h2 = g2.predict(x)
    assert np.array_equal(p1, p2) and h1 == h2
    s1, s2 = g.suggest(x), g2.suggest(x)
    assert s1.order == s2.order and s1.offset == s2.offset


def test_init_guide_equals_the_reference():
    for seed in (0, 7):
        ours, ref = init_guide(seed=seed), ref_guide.init_guide(seed=seed)
        for k in IIGuide.PARAM_KEYS:
            assert np.array_equal(ours.params[k], ref.params[k]), k


def _suite_features():
    from repro_torch.core.arch import arch
    return [cell_features(suite.get(n), arch(f)) for n in suite.names()
            for f in ("2x2", "3x3", "4x4")]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_from_either_package_suggests_alike(tmp_path, writer):
    """A checkpoint written by one package loads in the other, and both
    numpy forwards give the same suggestion on every suite cell (bit for
    bit: the same float32 arithmetic on the same arrays)."""
    path = str(tmp_path / "g.npz")
    if writer == "port":
        init_guide(seed=4).save(path)
    else:
        ref_guide.init_guide(seed=4).save(path)
    ours, ref = IIGuide.load(path), ref_guide.IIGuide.load(path)
    for x in _suite_features():
        a, b = ours.suggest(x), ref.suggest(x)
        assert (a.offset, a.order, a.probs, a.hopeless) == \
            (b.offset, b.order, b.probs, b.hopeless)


def test_guide_rejects_wrong_feature_width():
    g = init_guide()
    params = dict(g.params)
    for k in ("w1", "mean", "std"):
        params[k] = params[k][: N_FEATURES - 1]
    with pytest.raises(ValueError):
        IIGuide(params)


def test_suggest_sanitises_degenerate_forward_pass():
    g = init_guide()
    g.params["w1"] = np.full_like(g.params["w1"], np.nan)
    s = g.suggest(np.ones(N_FEATURES, dtype=np.float32))
    assert len(s.order) == N_OFFSETS
    assert all(np.isfinite(p) for p in s.probs)
    assert abs(sum(s.probs) - 1.0) < 1e-5
    assert 0.0 <= s.hopeless <= 1.0
    assert s.offset == 0          # uniform ties resolve lowest-first


def test_span_from_semantics():
    order = (3, 0, 6, 1, 2, 4, 5, 7)
    s = GuideSuggestion(offset=3, order=order,
                        probs=(0.0,) * N_OFFSETS, hopeless=0.0)
    r = ref_guide.GuideSuggestion(offset=3, order=order,
                                  probs=(0.0,) * N_OFFSETS, hopeless=0.0)
    assert s.span_from(0) == 4    # stretch to cover the predicted offset
    assert s.span_from(3) == 1    # already there: race exactly one II
    assert s.span_from(4) == 3    # best not-yet-passed candidate is 6
    assert s.span_from(99) == 1   # past every prediction: minimal windows
    assert [s.span_from(b) for b in range(12)] == \
        [r.span_from(b) for b in range(12)]
    hopeless = GuideSuggestion(offset=0, order=tuple(range(N_OFFSETS)),
                               probs=(0.0,) * N_OFFSETS, hopeless=0.9)
    assert hopeless.span_from(0) == MAX_GUIDED_SPAN


def test_registry_resolution(tmp_path):
    assert resolve_guide(None) is None
    assert resolve_guide("nope-not-registered") is None
    g = init_guide(seed=1)
    register_guide("mine", g)
    assert resolve_guide("mine") is g
    register_guide("mine", None)
    assert resolve_guide("mine") is None
    path = str(tmp_path / "ckpt.npz")
    g.save(path)
    loaded = resolve_guide(path)
    assert isinstance(loaded, IIGuide)
    assert resolve_guide(path) is loaded     # cached after first load
    bad = str(tmp_path / "garbage.npz")
    with open(bad, "wb") as f:
        f.write(b"not an npz")
    assert resolve_guide(bad) is None


# -------------------------------------------------------------- soundness

class _AdversarialGuide:
    """Worst-case guidance: always claims the II lives far above MII and
    that the cell is probably hopeless. May only waste wall-clock."""

    def suggest(self, features):
        order = tuple(range(N_OFFSETS - 1, -1, -1))
        return GuideSuggestion(offset=N_OFFSETS - 1, order=order,
                               probs=(1.0 / N_OFFSETS,) * N_OFFSETS,
                               hopeless=0.49)


SOUNDNESS_CELLS = [("sha", 3), ("gsm", 3), ("bitcount", 4)]


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("name,side", SOUNDNESS_CELLS,
                         ids=[n for n, _ in SOUNDNESS_CELLS])
def test_guided_sweep_ii_equals_unguided_and_the_reference(name, side,
                                                           width):
    """A random and an adversarial guide leave the port's final II equal
    to its unguided II and to the JAX package's, at widths 1 (the guide
    is ignored) and 4 (it picks the window extents)."""
    register_guide("random", init_guide(seed=9))
    register_guide("adversarial", _AdversarialGuide())
    cgra = CGRA(side, side)
    want = ref_map_loop(ref_suite.get(name), RefCGRA(side, side),
                        RefConfig(solver="auto", timeout_s=90),
                        sweep_width=width)
    base = map_loop(suite.get(name), cgra, CFG, sweep_width=width)
    assert (base.success, base.ii) == (want.success, want.ii)
    for spec in ("random", "adversarial"):
        cfg = MapperConfig(solver="auto", timeout_s=90, guide=spec)
        r = map_loop(suite.get(name), cgra, cfg, sweep_width=width)
        assert (r.success, r.ii) == (want.success, want.ii), (name, spec)
        if width == 1:
            assert r.guidance is None
            continue
        assert r.guidance["used"] and r.guidance["spans"]
        assert all(1 <= w <= 16 for w in r.guidance["spans"])
        # every II from MII up to the winner was attempted
        tried = {a.ii for a in r.attempts}
        assert set(range(r.mii, r.ii + 1)) <= tried


def test_guide_spans_equal_the_references_on_an_equal_guide(tmp_path):
    """The same checkpoint in both packages opens the same first window
    (its suggestion and so its spans depend only on the features)."""
    path = str(tmp_path / "g.npz")
    init_guide(seed=5).save(path)
    r = map_loop(suite.get("gsm"), CGRA(3, 3),
                 MapperConfig(solver="auto", timeout_s=90, guide=path),
                 sweep_width=4)
    want = ref_map_loop(ref_suite.get("gsm"), RefCGRA(3, 3),
                        RefConfig(solver="auto", timeout_s=90, guide=path),
                        sweep_width=4)
    assert r.ii == want.ii
    for k in ("used", "offset", "order", "hopeless"):
        assert r.guidance[k] == want.guidance[k], k
    assert r.guidance["spans"][0] == want.guidance["spans"][0]


def test_unresolvable_guide_name_runs_unguided():
    cfg = MapperConfig(solver="auto", timeout_s=90,
                       guide="no-such-guide-anywhere")
    r = map_loop(running_example(), CGRA(2, 2), cfg, sweep_width=4)
    base = map_loop(running_example(), CGRA(2, 2), CFG, sweep_width=4)
    assert r.success and r.ii == base.ii == 3
    assert r.guidance == {"guide": "no-such-guide-anywhere", "used": False}


def test_guide_ignored_at_sweep_width_one():
    register_guide("random", init_guide(seed=2))
    cfg = MapperConfig(solver="auto", timeout_s=90, guide="random")
    r = map_loop(running_example(), CGRA(2, 2), cfg, sweep_width=1)
    assert r.success and r.ii == 3
    assert r.guidance is None


def test_guide_through_compile_and_the_service(tmp_path):
    """``MapRequest.guide`` reaches the sweep standalone and through a
    MappingService (a path resolves in any process)."""
    path = str(tmp_path / "g.npz")
    init_guide(seed=3).save(path)
    g = suite.get("nw")
    r1 = compile(MapRequest(dfg=g, arch="2x2", sweep_width=4, guide=path))
    r2 = compile(MapRequest(dfg=suite.get("nw"), arch="2x2", sweep_width=4,
                            guide=path, service=MappingService()))
    r0 = compile(MapRequest(dfg=suite.get("nw"), arch="2x2", sweep_width=4))
    assert r1.ii == r2.ii == r0.ii
    assert r1.guidance["used"] and r2.guidance["used"]


def test_map_cgra_guide_flag(tmp_path, capsys):
    from repro_torch.launch import map_cgra
    path = str(tmp_path / "g.npz")
    init_guide(seed=6).save(path)
    map_cgra.main(["--arch", "mamba2_370m", "--cgra", "3x3", "--sweep", "4",
                   "--guide", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[guide offset=" in out and "spans=" in out
    assert "NO MAPPING" not in out and "mismatch" not in out


# --------------------------------------------------------------- training

def _jax_loss(p, z, y_off, y_hop):
    """The JAX package's ``train_guide`` loss (``src/repro/core/guide.py``),
    rebuilt here since the reference keeps it local to its trainer."""
    h = jnp.tanh(z @ p["w1"] + p["b1"])
    logits = h @ p["wo"] + p["bo"]
    ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                         y_off).mean()
    hop_logit = (h @ p["wh"] + p["bh"]).reshape(-1)
    bce = optax.sigmoid_binary_cross_entropy(hop_logit, y_hop).mean()
    return ce + 0.25 * bce


def _batch(n=96, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, (n, N_FEATURES)).astype(np.float32)
    yo = rng.integers(0, N_OFFSETS, n).astype(np.int32)
    yh = (rng.random(n) < 0.2).astype(np.float32)
    return z, yo, yh


def test_one_training_step_matches_jax_optax():
    """Loss and gradients of one step from init_guide's parameters on the
    same batch: rtol 1e-5, atol 1e-6."""
    params = init_guide(seed=11, hidden=32).params
    z, yo, yh = _batch()
    model = _mlp(params, "cpu")
    loss = _loss(model, torch.tensor(z), torch.tensor(yo, dtype=torch.int64),
                 torch.tensor(yh))
    loss.backward()
    jp = {k: jnp.asarray(params[k]) for k in TRAINED}
    jl, jg = jax.value_and_grad(_jax_loss)(jp, jnp.asarray(z),
                                           jnp.asarray(yo), jnp.asarray(yh))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-6)
    for k in TRAINED:
        np.testing.assert_allclose(getattr(model, k).grad.numpy(),
                                   np.asarray(jg[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_twenty_adam_steps_match_optax():
    """20 Adam steps (lr 3e-3, optax's defaults) over the same batches —
    the port's permutations fed to an optax loop — end within atol 1e-5."""
    params = init_guide(seed=12, hidden=32).params
    z, yo, yh = _batch(n=80, seed=1)
    perms = _epoch_perms(12, len(z), 10)           # 2 batches of 40 each
    model, loss = _fit(params, z, yo, yh, perms, lr=3e-3, batch=40,
                       device=torch.device("cpu"))
    jp = {k: jnp.asarray(params[k]) for k in TRAINED}
    opt = optax.adam(3e-3)
    state = opt.init(jp)
    step = jax.jit(lambda p, s, a, b, c: _adam_step(opt, p, s, a, b, c))
    jl = None
    for perm in perms.numpy():
        for i in range(0, len(z), 40):
            idx = perm[i:i + 40]
            jp, state, jl = step(jp, state, z[idx], yo[idx], yh[idx])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    for k in TRAINED:
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(jp[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def _adam_step(opt, p, s, z, y_off, y_hop):
    loss, grads = jax.value_and_grad(_jax_loss)(p, z, y_off, y_hop)
    updates, s = opt.update(grads, s, p)
    return optax.apply_updates(p, updates), s, loss


def test_epoch_perms_come_from_the_seeded_generator():
    a, b = _epoch_perms(3, 17, 4), _epoch_perms(3, 17, 4)
    assert torch.equal(a, b) and a.shape == (4, 17)
    assert all(sorted(row.tolist()) == list(range(17)) for row in a)
    assert not torch.equal(a, _epoch_perms(4, 17, 4))


def _synthetic_records(cls, n=160, seed=0):
    """Records whose offset is a simple function of one feature — enough
    signal for a tiny MLP to beat the offset-0 baseline."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        feats = rng.normal(0, 1, N_FEATURES).astype(np.float32)
        off = int(feats[0] > 0) + int(feats[1] > 0)   # offsets 0..2
        key = bytes([int(rng.integers(0, 256))]) + bytes(31)
        recs.append(cls(
            key=key, dfg_key=bytes(32), name=f"s{i}", kind="random",
            fabric="2x2", n_nodes=8, features=feats, mii=3, ii=3 + off,
            success=True, infeasible=False, attempts=(), total_time=0.01))
    return recs


def test_train_guide_learns_like_the_reference():
    """Held-out hit@1 on the synthetic records is at least the JAX
    package's minus 0.05 (the batch orders differ), and beats the
    always-MII baseline; the parameters trained on the default device."""
    guide, m = train_guide(_synthetic_records(CellRecord), seed=0,
                           hidden=16, epochs=60, batch=64)
    _, ref = ref_guide.train_guide(_synthetic_records(RefCellRecord),
                                   seed=0, hidden=16, epochs=60, batch=64)
    assert m["device"] == "cpu"
    assert (m["n_train"], m["n_heldout"], m["baseline_hit1"]) == \
        (ref["n_train"], ref["n_heldout"], ref["baseline_hit1"])
    assert m["hit1"] >= ref["hit1"] - 0.05
    assert m["hit1"] > m["baseline_hit1"]
    assert np.isfinite(m["final_loss"])
    s = guide.suggest(np.zeros(N_FEATURES, dtype=np.float32))
    assert 0 <= s.offset < N_OFFSETS


def test_train_guide_refuses_a_missing_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch import device as device_mod
    from repro_torch.device import DeviceUnavailable
    with pytest.raises(DeviceUnavailable):
        repro_torch.set_default_device("cuda")
    # the port's default (cuda) on a machine without it: training raises
    # rather than running on the CPU
    saved = device_mod._DEFAULT
    device_mod._DEFAULT = "cuda"
    try:
        with pytest.raises(DeviceUnavailable):
            train_guide(_synthetic_records(CellRecord, n=8), epochs=1)
    finally:
        device_mod._DEFAULT = saved


def test_train_guide_drops_infeasible_cells():
    recs = _synthetic_records(CellRecord, n=20)
    recs[0].infeasible = True
    recs[1].ii = None
    recs[1].success = False
    X, yo, yh, held = _dataset_arrays(recs)
    assert len(X) == 19                       # infeasible dropped
    assert yo.max() <= N_OFFSETS - 1
    assert yh.sum() == 1.0                    # the refuted cell labels hop
    ref = ref_guide._dataset_arrays(recs)
    for a, b in zip((X, yo, yh, held), ref):
        assert np.array_equal(a, b)
