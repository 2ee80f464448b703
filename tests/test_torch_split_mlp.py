"""The port's paper MLP against the JAX package's: configs, partitioners,
the synthetic financial datasets, towers, the split and centralized
models and their train steps, the drop masks and the MLP cost models.

Inputs: the datasets (numpy, the same seed in both packages), features
made from a seed with numpy, and the JAX package's seeded init carried
across by ``interop`` (torch cannot reproduce ``jax.random``); drop runs
hand the JAX package's live masks to the port.  f32 throughout.
Tolerances: exact for configs, partitions, data and costs; 1e-6 for
forwards, gradients and the loss; 1e-5 for five train steps' losses,
params and optimizer state (the two packages sum in different orders,
nothing else differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import vertical_mlp as jax_configs
from repro.core import costs as jax_costs
from repro.core import dropping as jax_dropping
from repro.core import merge as jax_merge
from repro.core import partition as jax_partition
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.data import synthetic as jax_synthetic
from repro.optim import AdamW as JaxAdamW
from repro.optim import SGD as JaxSGD
from repro_torch.configs import vertical_mlp
from repro_torch.configs.vertical_mlp import (FINANCIAL_PHRASEBANK,
                                              PAPER_DATASETS, MLPSplitConfig)
from repro_torch.core import costs, dropping, merge, partition, split_model
from repro_torch.core import towers
from repro_torch.data import synthetic
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.optim import SGD, AdamW
from repro_torch.tree_util import tree_leaves

MERGES = ("max", "avg", "concat", "mul", "sum")
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_params(cfg, seed=0):
    """The JAX package's seeded init, and the same numbers as tensors."""
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(seed), cfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _features(cfg, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    return x, y


def _close(got, want, tol):
    """``got`` a tree of tensors, ``want`` the same tree of JAX arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, tol)
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# configs, partitions, merged width
# ---------------------------------------------------------------------------

def test_configs_are_the_jax_configs():
    assert set(PAPER_DATASETS) == set(jax_configs.PAPER_DATASETS)
    for name, cfg in PAPER_DATASETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_configs.PAPER_DATASETS[name])
    for attr in ("BANK_MARKETING", "GIVE_ME_CREDIT", "FINANCIAL_PHRASEBANK"):
        assert getattr(vertical_mlp, attr) == PAPER_DATASETS[
            getattr(vertical_mlp, attr).name]
    assert [f.name for f in dataclasses.fields(MLPSplitConfig)] == [
        f.name for f in dataclasses.fields(jax_configs.MLPSplitConfig)]


@pytest.mark.parametrize("kw,match", [
    (dict(input_dim=10, client_feature_sizes=(4, 4)), "must sum"),
    (dict(input_dim=8, client_feature_sizes=(8,)), "one feature size"),
])
def test_config_checks_are_the_jax_checks(kw, match):
    base = dict(name="bad", num_classes=2, num_clients=2)
    for cls in (MLPSplitConfig, jax_configs.MLPSplitConfig):
        with pytest.raises(ValueError, match=match):
            cls(**base, **kw)


@pytest.mark.parametrize("n,k,seed", [(16, 2, 0), (25, 2, 3), (300, 4, 7),
                                      (10, 3, 1), (7, 7, 2)])
def test_partitioners_match_jax(n, k, seed):
    def slices(parts):
        return [(s.client, s.indices, s.size) for s in parts]

    assert set(partition.PARTITIONERS) == set(jax_partition.PARTITIONERS)
    for name, fn in partition.PARTITIONERS.items():
        args = (n, k, seed) if name == "random" else (n, k)
        got = fn(*args)
        assert slices(got) == slices(jax_partition.PARTITIONERS[name](*args))
        partition.validate_partition(got, n)
    sizes = tuple(s.size for s in partition.contiguous_partition(n, k))
    assert slices(partition.by_source_partition(sizes)) == slices(
        jax_partition.by_source_partition(sizes))
    for cfg in PAPER_DATASETS.values():
        assert slices(split_model.feature_slices(cfg)) == slices(
            jax_split_model.feature_slices(cfg))


@pytest.mark.parametrize("bad,match", [
    ([(0, (0, 1)), (1, (1, 2))], "overlaps"), ([(0, (0,)), (1, (2,))],
                                               "misses")])
def test_validate_partition_refuses_like_jax(bad, match):
    for mod in (partition, jax_partition):
        with pytest.raises(ValueError, match=match):
            mod.validate_partition([mod.FeatureSlice(c, i) for c, i in bad],
                                   3)


def test_client_columns_take_a_contiguous_slice_and_refuse_others():
    """A contiguous slice's columns are those the JAX package gathers by
    index; a strided or random slice is refused, never read as a range."""
    x = torch.arange(4 * 12, dtype=torch.float32).view(4, 12)
    for s in partition.contiguous_partition(12, 3):
        np.testing.assert_array_equal(
            to_numpy(split_model.client_columns(x, s)),
            to_numpy(x)[:, np.asarray(s.indices)])
    for s in (partition.strided_partition(12, 3)[0],
              partition.random_partition(12, 3, seed=0)[0]):
        with pytest.raises(ValueError, match="not a contiguous range"):
            split_model.client_columns(x, s)


@pytest.mark.parametrize("strategy", MERGES)
def test_merged_dim_matches_jax(strategy):
    for cut, k in ((16, 2), (64, 4), (7, 3)):
        assert merge.merged_dim(strategy, cut, k) == jax_merge.merged_dim(
            strategy, cut, k)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAPER_DATASETS))
def test_datasets_equal_jax_bit_for_bit(name):
    got = synthetic.make_dataset(name, seed=3)
    want = jax_synthetic.make_dataset(name, seed=3)
    for split in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, split), getattr(want, split)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.num_features, got.num_classes) == (want.num_features,
                                                   want.num_classes)
    # the whole split moves to the device once; the tensors are the arrays
    dev = synthetic.to_device(got, "cpu")
    for split in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(dev, split).numpy(),
                                      getattr(want, split))
    assert dev.num_classes == want.num_classes


def test_minibatches_equal_jax_on_numpy_and_tensors():
    ds = synthetic.make_dataset("financial_phrasebank")
    dev = synthetic.to_device(ds, "cpu")
    want = list(jax_synthetic.minibatches(ds.x_train, ds.y_train, 256,
                                          seed=5, epochs=2))
    got = list(synthetic.minibatches(ds.x_train, ds.y_train, 256, seed=5,
                                     epochs=2))
    got_dev = list(synthetic.minibatches(dev.x_train, dev.y_train, 256,
                                         seed=5, epochs=2))
    assert len(got) == len(got_dev) == len(want) == 2 * (len(ds.x_train)
                                                         // 256)
    for (xa, ya), (xt, yt), (xw, yw) in zip(got, got_dev, want):
        np.testing.assert_array_equal(xa, xw)
        np.testing.assert_array_equal(ya, yw)
        np.testing.assert_array_equal(xt.numpy(), xw)
        np.testing.assert_array_equal(yt.numpy(), yw)


# ---------------------------------------------------------------------------
# towers and the split model
# ---------------------------------------------------------------------------

def test_tower_matches_jax():
    jtower = jax_towers.init_mlp_tower(jax.random.PRNGKey(2), [75, 128, 64])
    tower = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtower),
                              "cpu")
    x = np.random.default_rng(0).standard_normal((BATCH, 75)).astype(
        np.float32)
    _close(towers.mlp_tower_apply(tower, torch.from_numpy(x)),
           jax_towers.mlp_tower_apply(jtower, jnp.asarray(x)), FWD_TOL)


def test_tower_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    tower = towers.init_mlp_tower(gen, [300, 128, 64])
    jtower = jax_towers.init_mlp_tower(jax.random.PRNGKey(0), [300, 128, 64])
    assert {k: tuple(v.shape) for k, v in tower.items()} == {
        k: tuple(v.shape) for k, v in jtower.items()}
    assert float(tower["w0"].abs().max()) <= 2 / np.sqrt(300) + 1e-7
    assert float(tower["w0"].std()) == pytest.approx(
        float(jnp.std(jtower["w0"])), rel=0.05)
    assert not tower["b0"].any()


def _masks(k):
    """No mask, the last client dropped, all but client 0 dropped."""
    one = np.ones(k, np.float32)
    one[-1] = 0.0
    only = np.zeros(k, np.float32)
    only[0] = 1.0
    return [None, one, only]


@pytest.mark.parametrize("merge_name", MERGES)
@pytest.mark.parametrize("cfg", [FINANCIAL_PHRASEBANK,
                                 PAPER_DATASETS["bank_marketing"]],
                         ids=lambda c: c.name)
def test_split_forward_and_loss_match_jax(cfg, merge_name):
    cfg = dataclasses.replace(cfg, merge=merge_name)
    jparams, params = _jax_params(cfg)
    x, y = _features(cfg)
    for mask in _masks(cfg.num_clients):
        jlogits = jax_split_model.split_forward(
            jparams, jnp.asarray(x), cfg,
            live_mask=None if mask is None else jnp.asarray(mask))
        logits = split_model.split_forward(
            params, torch.from_numpy(x), cfg,
            live_mask=None if mask is None else torch.from_numpy(mask))
        _close(logits, jlogits, FWD_TOL)
        _close(split_model.softmax_xent(logits, torch.from_numpy(y),
                                        cfg.num_classes),
               jax_split_model.softmax_xent(jlogits, jnp.asarray(y),
                                            cfg.num_classes), FWD_TOL)


def test_centralized_forward_matches_jax():
    cfg = FINANCIAL_PHRASEBANK
    jparams = jax_split_model.init_centralized_mlp(jax.random.PRNGKey(1), cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    x, _ = _features(cfg)
    _close(split_model.centralized_forward(params, torch.from_numpy(x)),
           jax_split_model.centralized_forward(jparams, jnp.asarray(x)),
           FWD_TOL)
    gen = torch.Generator().manual_seed(0)
    own = split_model.init_centralized_mlp(gen, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}


@pytest.mark.parametrize("merge_name", MERGES)
def test_split_init_shapes_match_jax(merge_name):
    cfg = dataclasses.replace(FINANCIAL_PHRASEBANK, merge=merge_name)
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(0), cfg)
    params = split_model.init_split_mlp(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    # the same seed gives the same init; another seed another
    again = split_model.init_split_mlp(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")
    assert torch.equal(again["server"]["w0"], params["server"]["w0"])
    other = split_model.init_split_mlp(torch.Generator().manual_seed(1), cfg,
                                       device="cpu")
    assert not torch.equal(other["server"]["w0"], params["server"]["w0"])


def test_max_merge_splits_a_tie_as_jax_does():
    """Two clients holding the same maximum share its gradient evenly, in
    both packages."""
    cfg = dataclasses.replace(PAPER_DATASETS["bank_marketing"],
                              client_feature_sizes=(8, 8))
    jparams, params = _jax_params(cfg)
    # the same tower on both clients and the same columns: every cut ties
    jparams["towers"][1] = jparams["towers"][0]
    params["towers"][1] = params["towers"][0]
    x, y = _features(cfg)
    x[:, 8:] = x[:, :8]

    def jloss(p):
        return jax_split_model.softmax_xent(jax_split_model.split_forward(
            p, jnp.asarray(x), cfg), jnp.asarray(y), cfg.num_classes)

    jgrads = jax.grad(jloss)(jparams)
    loss, grads = split_model._value_and_grad(
        lambda p: split_model.softmax_xent(split_model.split_forward(
            p, torch.from_numpy(x), cfg), torch.from_numpy(y),
            cfg.num_classes), params)
    _close(grads, jgrads, FWD_TOL)
    # each tied tower gets half the credit: the two towers' grads are equal
    _close(grads["towers"][0], grads["towers"][1], FWD_TOL)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

STEPS = 5


def _run_steps(cfg, jopt, opt, num_drop=0, check_params=True):
    """Five steps of both packages' split step from the JAX init; with
    drops, the JAX step's masks (drawn from its keys) go to the port.
    Returns both optimizer states, both final params and, per element,
    the first nonzero gradient of the JAX run (0 where every step's was
    zero)."""
    jparams, params = _jax_params(cfg)
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = jax_split_model.make_split_train_step(cfg, jopt,
                                                  num_drop=num_drop)
    step = split_model.make_split_train_step(cfg, opt, num_drop=num_drop)
    key = jax.random.PRNGKey(0)
    first = jax.tree_util.tree_map(np.zeros_like, jparams)
    for i in range(STEPS):
        x, y = _features(cfg, seed=10 + i)
        key, sub = jax.random.split(key)
        jmask = live = None
        if num_drop:
            jmask = jax_dropping.sample_live_mask(sub, cfg.num_clients,
                                                  num_drop)
            assert int(jmask.sum()) == cfg.num_clients - num_drop
            live = torch.from_numpy(np.array(jmask))
        jgrads = jax.grad(lambda p: jax_split_model.softmax_xent(
            jax_split_model.split_forward(p, jnp.asarray(x), cfg,
                                          live_mask=jmask),
            jnp.asarray(y), cfg.num_classes))(jparams)
        first = jax.tree_util.tree_map(
            lambda f, g: np.where(f == 0, np.asarray(g), f), first, jgrads)
        jparams, jstate, jloss = jstep(jparams, jstate, sub, jnp.asarray(x),
                                       jnp.asarray(y))
        params, state, loss = step(params, state, None, torch.from_numpy(x),
                                   torch.from_numpy(y), live_mask=live)
        _close(loss, jloss, STEP_TOL)
        if check_params:
            _close(params, jparams, STEP_TOL)
    return jstate, state, jparams, params, first


@pytest.mark.parametrize("num_drop", [0, 1, 2, 3])
@pytest.mark.parametrize("merge_name", MERGES)
def test_split_train_step_matches_jax(merge_name, num_drop):
    """Five steps on PhraseBank (K = 4) under SGD with momentum, whose
    update is linear in the gradient: losses, params and velocities at
    1e-5."""
    cfg = dataclasses.replace(FINANCIAL_PHRASEBANK, merge=merge_name)
    jstate, state, *_ = _run_steps(
        cfg, JaxSGD(learning_rate=0.05, momentum=0.9),
        SGD(learning_rate=0.05, momentum=0.9), num_drop)
    _close(state["velocity"], jstate["velocity"], STEP_TOL)


#: AdamW's moments: relative 1e-5, with an absolute floor far below the
#: values held (mu ~ 1e-4, nu ~ 1e-9 on a live gradient); mu's floor is
#: the gradients' own 1e-6 times (1 - b1)
MOMENT_TOL = dict(mu=dict(rtol=1e-5, atol=1e-7),
                  nu=dict(rtol=1e-5, atol=1e-12))
#: below this, an element's first nonzero gradient is "near zero"
NEAR_ZERO_GRAD = 1e-6


@pytest.mark.parametrize("merge_name", MERGES)
def test_split_train_step_adamw_matches_jax(merge_name):
    """Five AdamW steps at the paper's learning rate, two of four clients
    dropped: losses at 1e-5, both moments at rtol 1e-5 (``MOMENT_TOL``),
    params at 1e-5 wherever the element's first nonzero gradient is not
    near zero.  Where it is (|g| <= 1e-6, as low as ~5e-9 here), AdamW's
    first update ``g / (|g| + eps)`` with eps 1e-8 turns the packages'
    ~1e-10 summation-order difference in g into a param difference
    (1.3e-5 = 0.0044 lr on concat's worst element, whose first gradient
    is 5.1e-9); those elements are held within one update, ``lr``.  The test asserts that every param beyond 1e-5 is one of
    them, so that the cause is shown, not assumed."""
    lr = 3e-3
    cfg = dataclasses.replace(FINANCIAL_PHRASEBANK, merge=merge_name)
    jstate, state, jparams, params, first = _run_steps(
        cfg, JaxAdamW(learning_rate=lr), AdamW(learning_rate=lr),
        num_drop=2, check_params=False)
    for moment, tol in MOMENT_TOL.items():
        _close(state[moment], jstate[moment], tol)
    got = [to_numpy(p) for p in tree_leaves(params)]
    want = [np.asarray(p) for p in jax.tree_util.tree_leaves(jparams)]
    first = jax.tree_util.tree_leaves(first)
    assert len(got) == len(want) == len(first)
    for g, w, f in zip(got, want, first):
        assert g.shape == w.shape == f.shape
        diff = np.abs(g - w)
        near_zero = np.abs(f) <= NEAR_ZERO_GRAD
        np.testing.assert_allclose(g[~near_zero], w[~near_zero],
                                   **STEP_TOL)
        assert diff[near_zero].max(initial=0.0) <= lr
        # the cause: every param beyond 1e-5 had a near-zero gradient
        assert near_zero[diff > STEP_TOL["atol"] + STEP_TOL["rtol"] *
                         np.abs(w)].all()


def test_split_train_step_draws_its_own_masks():
    """Without an injected mask the step draws one per call from its
    generator: the same seed gives the same run, and a step with drops
    differs from one without."""
    cfg = FINANCIAL_PHRASEBANK
    _, params = _jax_params(cfg)
    x, y = (torch.from_numpy(a) for a in _features(cfg))
    opt = AdamW(learning_rate=3e-3)
    losses = []
    for seed, nd in ((0, 2), (0, 2), (1, 2), (0, 0)):
        step = split_model.make_split_train_step(cfg, opt, num_drop=nd)
        gen = torch.Generator().manual_seed(seed)
        p, s = params, opt.init(params)
        run = []
        for _ in range(3):
            p, s, loss = step(p, s, gen, x, y)
            run.append(float(loss))
        losses.append(run)
    assert losses[0] == losses[1]
    assert losses[0] != losses[2] and losses[0] != losses[3]
    step = split_model.make_split_train_step(cfg, opt, num_drop=1)
    with pytest.raises(ValueError, match="generator or a live_mask"):
        step(params, opt.init(params), None, x, y)


def test_centralized_train_step_matches_jax():
    cfg = PAPER_DATASETS["give_me_credit"]
    jparams = jax_split_model.init_centralized_mlp(jax.random.PRNGKey(0), cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    jopt = JaxSGD(learning_rate=0.05, momentum=0.9)
    opt = SGD(learning_rate=0.05, momentum=0.9)
    jstate, state = jopt.init(jparams), opt.init(params)
    jstep = jax_split_model.make_centralized_train_step(cfg, jopt)
    step = split_model.make_centralized_train_step(cfg, opt)
    for i in range(STEPS):
        x, y = _features(cfg, seed=20 + i)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(x),
                                       jnp.asarray(y))
        params, state, loss = step(params, state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        _close(loss, jloss, STEP_TOL)
        _close(params, jparams, STEP_TOL)


def test_compression_is_refused_by_name():
    """Cut compression is ported: ``split_forward`` and the split train
    step run the codec on every cut (straight through) as the JAX
    package's do, and an unknown scheme is refused by name as there."""
    cfg = FINANCIAL_PHRASEBANK
    jparams, params = _jax_params(cfg)
    x, y = _features(cfg)
    for scheme in ("int8", "topk"):
        want = jax_split_model.split_forward(jparams, jnp.asarray(x), cfg,
                                             compression=scheme)
        got = split_model.split_forward(params, torch.from_numpy(x), cfg,
                                        compression=scheme)
        _close(got, want, STEP_TOL)
    jopt, opt = JaxAdamW(), AdamW()
    jstep = jax_split_model.make_split_train_step(cfg, jopt,
                                                  compression="topk")
    step = split_model.make_split_train_step(cfg, opt, compression="topk")
    jp, _, jloss = jstep(jparams, jopt.init(jparams), jax.random.PRNGKey(0),
                         jnp.asarray(x), jnp.asarray(y))
    p, _, loss = step(params, opt.init(params), None, torch.from_numpy(x),
                      torch.from_numpy(y))
    _close(loss, jloss, STEP_TOL)
    _close(p, jp, STEP_TOL)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        split_model.split_forward(params, torch.from_numpy(x), cfg,
                                  compression="fp8")


def test_entry_points_default_to_cuda():
    """Without device="cpu" the new entry points want the card, and raise
    where there is none — never a silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    cfg = FINANCIAL_PHRASEBANK
    ds = synthetic.make_dataset("financial_phrasebank")
    for call in (lambda: split_model.init_split_mlp(None, cfg),
                 lambda: split_model.init_centralized_mlp(None, cfg),
                 lambda: synthetic.to_device(ds)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# drop masks
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 12), data=st.data())
def test_sample_live_mask_drops_exactly_num_drop(k, data):
    num_drop = data.draw(st.integers(0, k - 1))
    gen = torch.Generator().manual_seed(data.draw(st.integers(0, 2 ** 31)))
    live = dropping.sample_live_mask(gen, k, num_drop)
    assert live.dtype == torch.float32 and live.shape == (k,)
    assert set(live.tolist()) <= {0.0, 1.0}
    assert int(live.sum()) == k - num_drop


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sample_live_mask_refuses_dropping_everyone(k):
    for mod, key in ((dropping, torch.Generator()),
                     (jax_dropping, jax.random.PRNGKey(0))):
        with pytest.raises(ValueError, match="every client"):
            mod.sample_live_mask(key, k, k)


def test_sample_live_mask_is_uniform_over_clients():
    """Over many draws each client is dropped about num_drop / K of the
    time (2000 draws: 3 sigma is under 0.035)."""
    gen = torch.Generator().manual_seed(0)
    drops = sum(1.0 - dropping.sample_live_mask(gen, 4, 1)
                for _ in range(2000)) / 2000
    np.testing.assert_allclose(drops.numpy(), 0.25, atol=0.035)


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 12), p=st.floats(0.0, 1.0), seed=st.integers(0, 999))
def test_bernoulli_live_mask_keeps_one_client(k, p, seed):
    live = dropping.bernoulli_live_mask(torch.Generator().manual_seed(seed),
                                        k, p)
    assert live.dtype == torch.float32 and live.shape == (k,)
    assert set(live.tolist()) <= {0.0, 1.0}
    assert live.sum() >= 1
    if p == 0.0:
        assert int(live.sum()) == k
    if p == 1.0:  # everyone dropped: exactly one is resurrected
        assert int(live.sum()) == 1


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge_name", MERGES)
@pytest.mark.parametrize("name", sorted(PAPER_DATASETS))
def test_mlp_costs_equal_jax(name, merge_name):
    cfg = dataclasses.replace(PAPER_DATASETS[name], merge=merge_name)
    dims = [cfg.input_dim, *cfg.tower_hidden, cfg.cut_dim]
    assert costs.mlp_forward_flops(dims, 3) == jax_costs.mlp_forward_flops(
        dims, 3)
    assert costs.mlp_param_count(dims) == jax_costs.mlp_param_count(dims)
    assert costs.split_mlp_params(cfg) == jax_costs.split_mlp_params(cfg)
    assert costs.split_mlp_flops_per_sample(
        cfg) == jax_costs.split_mlp_flops_per_sample(cfg)
    assert synthetic._SPECS[name] == jax_synthetic._SPECS[name]
    n = synthetic._SPECS[name][0]
    for batch, aux in ((32, False), (256, True)):
        got = costs.epoch_traffic(cfg, n, batch, aux_loss=aux)
        want = jax_costs.epoch_traffic(cfg, n, batch, aux_loss=aux)
        assert {r: dataclasses.asdict(t) for r, t in got.items()} == {
            r: dataclasses.asdict(t) for r, t in want.items()}
