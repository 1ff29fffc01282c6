"""The port's trainer slice against the reference package.

DLRM forward, loss and gradients, the row-wise AdaGrad table update, the
AdamW optimizer and its schedule, the tiered embedding store and the
Trainer's sparse and dense loops go through both packages on the same
inputs, made with numpy from a seed.  JAX's PRNG cannot be matched, so
the reference's initial weights are carried across with
``repro_torch.convert``.  Tolerances are stated per test: float32 on the
CPU, with sums taken in another order by the two frameworks.
"""
import dataclasses
import hashlib
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch.train import dlrm_dpp_batches as j_dlrm_dpp_batches  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.dlrm import DLRMConfig as JDLRMConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import embedding_cache as jcache  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.dlrm import DLRMConfig  # noqa: E402
from repro_torch.train import (  # noqa: E402
    TieredEmbeddingStore,
    Trainer,
    TrainerConfig,
    embedding_cache,
    init_tables,
    make_store_for_model,
)

SMOKE = configs.get_smoke_config("dlrm-paper")
J_SMOKE = jconfigs.get_smoke_config("dlrm-paper")
FWD_TOL = dict(rtol=1e-5, atol=1e-6)     # forward values, float32
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)    # gradients, losses over steps


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _j_params(cfg, seed=0):
    return _np_tree(j_build_model(cfg).init(jax.random.PRNGKey(seed)))


def _batch(cfg, n, seed, mask_p=0.7):
    rng = np.random.default_rng(seed)
    shape = (n, cfg.num_tables, cfg.max_ids_per_feature)
    mask = (rng.random(shape) < mask_p).astype(np.float32)
    mask[0, 0] = 0.0                                      # an empty bag
    return {
        "dense": rng.normal(0, 1, (n, cfg.num_dense)).astype(np.float32),
        "sparse_ids": rng.integers(0, cfg.vocab_per_table, shape).astype(np.int32),
        "sparse_mask": mask,
        "label": rng.integers(0, 2, n).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_model(cfg, jparams, tables=True):
    model = build_model(cfg, tables=tables, device="cpu")
    state = convert.dlrm_params_from_numpy(
        jparams if tables else {k: v for k, v in jparams.items() if k != "tables"})
    with torch.no_grad():
        for k, p in model.params().items():
            p.copy_(state[k])
    return model


# -- model ------------------------------------------------------------------------


def test_dlrm_forward_loss_and_ne_match_jax():
    jmodel = j_build_model(J_SMOKE)
    jp = _j_params(J_SMOKE)
    model = _port_model(SMOKE, jp)
    b = _batch(SMOKE, 16, seed=1)
    jb, tb = _j(b), _t(b)
    np.testing.assert_allclose(model.forward(tb).detach().numpy(),
                               np.asarray(jmodel.forward(jp, jb)), **FWD_TOL)
    np.testing.assert_allclose(model.loss(tb).item(), float(jmodel.loss(jp, jb)), **FWD_TOL)
    np.testing.assert_allclose(model.normalized_entropy(tb).item(),
                               float(jmodel.normalized_entropy(jp, jb)), **FWD_TOL)
    jpooled = jmodel.pooled_embeddings(jp["tables"], jb)
    pooled = model.pooled_embeddings(model.tables, tb)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jpooled), **FWD_TOL)
    mlp = {k: jp[k] for k in ("bottom", "top")}
    np.testing.assert_allclose(
        model.loss_from_pooled(torch.from_numpy(np.array(jpooled)), tb).item(),
        float(jmodel.loss_from_pooled(mlp, jpooled, jb)), **FWD_TOL)


def test_dlrm_ids_clip_and_interaction_order():
    """Out-of-range ids clip to [0, V-1], and the interaction's pairs come
    in jnp.triu_indices order."""
    model = build_model(SMOKE, device="cpu")
    t = SMOKE.num_tables + 1
    iu, ju = np.triu_indices(t, k=1)
    assert np.array_equal(model._iu.numpy(), iu) and np.array_equal(model._ju.numpy(), ju)
    b = _batch(SMOKE, 4, seed=2)
    b2 = dict(b, sparse_ids=b["sparse_ids"].copy())
    b2["sparse_ids"][b2["sparse_ids"] == SMOKE.vocab_per_table - 1] = 10 ** 6
    b2["sparse_ids"][b2["sparse_ids"] == 0] = -5
    with torch.no_grad():
        assert torch.equal(model.forward(_t(b)), model.forward(_t(b2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_dlrm_gradients_match_jax(seed):
    """d(pooled) and every MLP gradient of loss_from_pooled, and the dense
    path's gradients (tables included), against jax.value_and_grad."""
    jmodel = j_build_model(J_SMOKE)
    jp = _j_params(J_SMOKE, seed)
    b = _batch(SMOKE, 16, seed=10 + seed)
    jb, tb = _j(b), _t(b)
    mlp = {k: jp[k] for k in ("bottom", "top")}
    jpooled = jmodel.pooled_embeddings(jp["tables"], jb)
    jloss, (jg, jgp) = jax.value_and_grad(
        lambda m, p: jmodel.loss_from_pooled(m, p, jb), argnums=(0, 1))(mlp, jpooled)

    model = _port_model(SMOKE, jp, tables=False)
    params = model.params()
    pooled = torch.from_numpy(np.array(jpooled)).requires_grad_(True)
    loss = model.loss_from_pooled(pooled, tb)
    *grads, gp = torch.autograd.grad(loss, [*params.values(), pooled])
    np.testing.assert_allclose(loss.item(), float(jloss), **FWD_TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), **GRAD_TOL)
    want = convert.dlrm_params_from_numpy(_np_tree(jg))
    assert list(params) == list(want)
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)

    dense = _port_model(SMOKE, jp)
    dparams = dense.params()
    dgrads = torch.autograd.grad(dense.loss(tb), list(dparams.values()))
    jdg = convert.dlrm_params_from_numpy(_np_tree(jax.grad(jmodel.loss)(jp, jb)))
    for k, g in zip(dparams, dgrads):
        np.testing.assert_allclose(g.numpy(), jdg[k].numpy(), err_msg=k, **GRAD_TOL)


def test_sparse_table_update_matches_jax():
    jmodel = j_build_model(J_SMOKE)
    model = build_model(SMOKE, tables=False, device="cpu")
    rng = np.random.default_rng(5)
    b = _batch(SMOKE, 8, seed=6)
    b["sparse_ids"][1, 2, :4] = 7                        # duplicate rows
    tables = rng.normal(0, 0.02, (SMOKE.num_tables, SMOKE.vocab_per_table,
                                  SMOKE.embed_dim)).astype(np.float32)
    acc = rng.random((SMOKE.num_tables, SMOKE.vocab_per_table)).astype(np.float32) * 1e-3
    dpooled = rng.normal(0, 1e-2, (8, SMOKE.num_tables, SMOKE.embed_dim)).astype(np.float32)
    jt, ja = jmodel.sparse_table_update(jnp.asarray(tables), jnp.asarray(acc),
                                        jnp.asarray(dpooled), _j(b), jnp.float32(0.05))
    pt, pa = model.sparse_table_update(torch.from_numpy(tables), torch.from_numpy(acc),
                                       torch.from_numpy(dpooled), _t(b), 0.05)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-8)
    assert not np.array_equal(pt.numpy(), tables)        # inputs kept, rows moved


def test_dlrm_sparse_update_matches_dense_gradient():
    """Row-wise sparse update direction == dense autograd table gradient
    (the port's counterpart of the reference's test of the same name)."""
    model = build_model(SMOKE, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    shape = (8, SMOKE.num_tables, SMOKE.max_ids_per_feature)
    bt = _t({
        "dense": rng.normal(0, 1, (8, SMOKE.num_dense)).astype(np.float32),
        "sparse_ids": rng.integers(0, SMOKE.vocab_per_table, shape).astype(np.int32),
        "sparse_mask": np.ones(shape, np.float32),
        "label": rng.integers(0, 2, 8).astype(np.float32),
    })
    (dense_grads,) = torch.autograd.grad(model.loss(bt), [model.tables])
    tables = model.tables.detach()
    pooled = model.pooled_embeddings(tables, bt).requires_grad_(True)
    (dpooled,) = torch.autograd.grad(model.loss_from_pooled(pooled, bt), [pooled])
    acc = torch.zeros(SMOKE.num_tables, SMOKE.vocab_per_table)
    new_tables, _ = model.sparse_table_update(tables, acc, dpooled, bt, lr=1.0)
    sparse_delta = (new_tables - tables).double().numpy()
    dg = dense_grads.double().numpy()
    touched = np.abs(dg) > 1e-12
    assert touched.any()
    assert (np.abs(sparse_delta[~touched]) < 1e-9).all()
    assert np.sum(sparse_delta * dg) < 0                 # descent direction


def test_dlrm_init_is_seeded_and_device_independent():
    def params(seed):
        return {k: p.detach() for k, p in build_model(SMOKE, seed=seed, device="cpu")
                .params().items()}

    a, b, c = params(3), params(3), params(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bottom.w0"], c["bottom.w0"])
    assert torch.count_nonzero(a["top.b0"]) == 0
    std = float(a["top.w0"].std())
    assert abs(std - 1 / np.sqrt(a["top.w0"].shape[0])) < 0.1 * std
    assert abs(float(a["tables"].std()) - 0.02) < 0.002


# -- optimizer ----------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(2, 8), (100, 10_000), (0, 5), (3, 1)])
def test_wsd_schedule_matches_jax(warmup, total):
    jc = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=warmup, total_steps=total)
    pc = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=warmup, total_steps=total)
    ends = (warmup, int(0.8 * total), total)
    steps = set(range(12)) | {s + d for s in ends for d in (-1, 0, 1, 2) if s + d >= 0}
    for step in sorted(steps):
        want = np.asarray(joptim.wsd_schedule(jc, jnp.int32(step)))
        got = optim.wsd_schedule(pc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # under and over clip_norm
def test_adamw_update_matches_jax(grad_scale):
    """Three AdamW steps on identical params, grads and state: clipping,
    bias correction, decay on ndim >= 2 only, the schedule's lr."""
    rng = np.random.default_rng(7)
    shapes = {"bottom": {"w0": (5, 4), "b0": (4,)}, "top": {"w0": (4, 1), "b0": (1,)},
              "tables": (3, 6, 4)}
    params = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    jc = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=3)
    pc = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=3)
    jp, js = params, joptim.adamw_init(params, jc)
    pp = convert.dlrm_params_from_numpy(params)
    ps = optim.adamw_init(pp, pc)
    for _ in range(3):
        g = jax.tree.map(lambda p: (rng.normal(0, 1, p.shape) * grad_scale).astype(np.float32), jp)
        jp, js, jn = joptim.adamw_update(jp, g, js, jc)
        pp, ps, pn = optim.adamw_update(pp, convert.dlrm_params_from_numpy(_np_tree(g)), ps, pc)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
    want_p = convert.dlrm_params_from_numpy(_np_tree(jp))
    want_s = convert.adamw_state_from_numpy(_np_tree(js))
    assert int(ps["step"]) == int(want_s["step"]) == 3
    for k in want_p:
        np.testing.assert_allclose(pp[k].numpy(), want_p[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        for m in ("mu", "nu"):
            # mu = b1*mu + (1-b1)*g cancels in a few elements, so the
            # absolute part is 1e-6 of the tensor's largest value
            w = want_s[m][k].numpy()
            np.testing.assert_allclose(ps[m][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=f"{m} {k}")


def test_global_norm_clip_and_compression_match_jax():
    rng = np.random.default_rng(8)
    tree = {"a": {"w": rng.normal(0, 3, (7, 3)).astype(np.float32)},
            "b": rng.normal(0, 3, (5,)).astype(np.float32)}
    flat = convert.dlrm_params_from_numpy(tree)
    np.testing.assert_allclose(float(optim.global_norm(flat)),
                               float(joptim.global_norm(tree)), rtol=1e-6)
    clipped, norm = optim.clip_by_global_norm(flat, 1.0)
    jclipped, jnorm = joptim.clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(clipped["a.w"].numpy(), np.asarray(jclipped["a"]["w"]), rtol=1e-6)
    back = optim.decompress_grads(optim.compress_grads(flat))
    jback = joptim.decompress_grads(joptim.compress_grads(tree))
    assert back["b"].dtype == torch.float32
    np.testing.assert_array_equal(back["b"].numpy(), np.asarray(jback["b"]))


def test_convert_round_trips():
    jp = _j_params(J_SMOKE)
    state = convert.dlrm_params_from_numpy(jp)
    assert sorted(state) == list(build_model(SMOKE, device="cpu").params())
    back = convert.dlrm_params_to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.tobytes() == b.tobytes()
    js = _np_tree(joptim.adamw_init(jp, joptim.OptimizerConfig()))
    js["step"] = np.asarray(5, np.int32)
    ps = convert.adamw_state_from_numpy(js)
    assert int(ps["step"]) == 5 and set(ps["mu"]) == set(state)
    jback = convert.adamw_state_to_numpy(ps)
    assert jax.tree.structure(jback) == jax.tree.structure(js)


# -- tiered embedding store ------------------------------------------------------------


def _zipf_traffic(n_batches, b, t, l, v, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        ids = (rng.zipf(1.3, (b, t, l)) - 1) % v
        lens = rng.integers(0, l + 1, (b, t))
        mask = (np.arange(l)[None, None, :] < lens[..., None]).astype(np.float32)
        yield ids.astype(np.int32), mask


def _stats(store):
    return dataclasses.asdict(store.stats) | {"hot_rate": store.stats.hot_rate}


@pytest.mark.parametrize("hot_rows,host_dram_rows", [(16, 24), (0, 0), (64, 0)])
def test_store_default_path_byte_identical_to_reference(hot_rows, host_dram_rows):
    """The same traffic and AdaGrad writes through both stores: pooled
    bags, host tables, AdaGrad state, residency and every statistic are
    byte-identical (admission, eviction and both host tiers exercised)."""
    tables = np.random.default_rng(0).normal(0, 0.01, (3, 60, 8)).astype(np.float32)
    kw = dict(admit_reads=2, host_dram_rows=host_dram_rows)
    js = jcache.TieredEmbeddingStore(tables, hot_rows, **kw)
    ps = TieredEmbeddingStore(tables, hot_rows, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i, (ids, mask) in enumerate(_zipf_traffic(10, 12, 3, 6, 60, seed=2)):
        got, want = ps.pooled(ids, mask), js.pooled(ids, mask)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        dp = rng.normal(0, 0.1, got.shape).astype(np.float32)
        lr = float(np.float32(0.05 / (1 + i)))
        js.apply_sparse_update(dp, ids, mask, lr=lr)
        ps.apply_sparse_update(dp, ids, mask, lr=lr)
        if i == 6:
            assert ps.bump_generation() == js.bump_generation()
    assert ps.host_tables().tobytes() == js.host_tables().tobytes()
    assert ps.adagrad_state().tobytes() == js.adagrad_state().tobytes()
    assert _stats(ps) == _stats(js)
    assert {k: v.tolist() for k, v in ps.hot_residency().items()} == \
           {k: v.tolist() for k, v in js.hot_residency().items()}
    if hot_rows:
        assert ps.stats.hot_hits > 0 and ps.stats.admitted > 0
    if host_dram_rows:
        assert ps.stats.flash_fetches > 0


def test_store_kernel_path_matches_reference_pallas_path():
    """pooled(use_kernel=True): the port's one launch per lookup (the plain
    version on the CPU) against the reference's per-table Pallas kernel
    in interpret mode.  The masks are 0/1, so every product is exact and
    XLA's FMA contraction changes nothing: the bags are bit-identical."""
    tables = np.random.default_rng(3).normal(0, 0.01, (3, 40, 16)).astype(np.float32)
    kw = dict(admit_reads=1)
    js = jcache.TieredEmbeddingStore(tables, 40, **kw)
    ps = TieredEmbeddingStore(tables, 40, device="cpu", **kw)
    for ids, mask in _zipf_traffic(4, 8, 3, 5, 40, seed=4):
        got = ps.pooled(ids, mask, use_kernel=True)
        want = js.pooled(ids, mask, use_kernel=True)
        assert got.tobytes() == want.tobytes()
        exact = ps.pooled(ids, mask)
        np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-9)
    assert ps.stats.kernel_bags == js.stats.kernel_bags > 0


def test_make_store_for_model_bytes_match_reference():
    cfg = JDLRMConfig(num_dense=4, num_tables=3, vocab_per_table=70, embed_dim=8,
                      max_ids_per_feature=4, bottom_mlp=(8,), top_mlp=(4, 1))
    pcfg = DLRMConfig(num_dense=4, num_tables=3, vocab_per_table=70, embed_dim=8,
                      max_ids_per_feature=4, bottom_mlp=(8,), top_mlp=(4, 1))
    js = jcache.make_store_for_model(cfg, 8, seed=3, admit_reads=2)
    ps = make_store_for_model(pcfg, 8, seed=3, admit_reads=2, device="cpu")
    assert ps.host_tables().tobytes() == js.host_tables().tobytes()
    assert init_tables(pcfg, 3).tobytes() == js.host_tables().tobytes()
    assert ps.admit_reads == js.admit_reads == 2 and ps.hot_capacity == 8
    for name in ("HBM_TIER", "DRAM_TIER", "FLASH_TIER"):
        assert dataclasses.asdict(getattr(embedding_cache, name)) == \
            dataclasses.asdict(getattr(jcache, name))


def test_cuda_store_trainer_and_model_raise_without_cuda(monkeypatch):
    """No fallback: a store, model or trainer asked for CUDA on a machine
    without it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TieredEmbeddingStore(tables, 2, device="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(SMOKE, device="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Trainer(SMOKE, device="cuda")


# -- trainer --------------------------------------------------------------------------


def _e2e_cfgs():
    kw = dict(num_dense=6, num_tables=3, vocab_per_table=500, embed_dim=8,
              max_ids_per_feature=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
    return JDLRMConfig(**kw), DLRMConfig(**kw)


def _sparse_batches(cfg, n, bs=32, seed=0):
    traffic = _zipf_traffic(n, bs, cfg.num_tables, cfg.max_ids_per_feature,
                            cfg.vocab_per_table, seed)
    rng = np.random.default_rng(seed + 100)
    w = np.random.default_rng(1234).normal(0, 1, cfg.num_dense).astype(np.float32)
    out = []
    for ids, mask in traffic:
        dense = rng.normal(0, 1, (bs, cfg.num_dense)).astype(np.float32)
        out.append({"dense": dense, "sparse_ids": ids, "sparse_mask": mask,
                    "label": (dense @ w > 0).astype(np.float32)})
    return out


def _port_state(jstate):
    np_params = _np_tree(jstate["params"])
    np_opt = _np_tree(jstate["opt"])
    return {"params": convert.dlrm_params_from_numpy(np_params),
            "opt": convert.adamw_state_from_numpy(np_opt), "step": 0}


def _losses(tr):
    return np.array([m.loss for m in tr.history])


@pytest.mark.parametrize("kernel_bags", [False, True])
def test_sparse_trainer_matches_reference(kernel_bags):
    """The tiered-store trainer against the reference's on the same
    batches and tables: per-step loss within rtol 1e-4 over 6 steps, the
    store's traffic statistics identical, the host tables close."""
    jcfg, pcfg = _e2e_cfgs()
    batches = _sparse_batches(pcfg, 6)
    kw = dict(seed=3, admit_reads=2, host_dram_rows=64)
    jstore = jcache.make_store_for_model(jcfg, 64, **kw)
    pstore = make_store_for_model(pcfg, 64, device="cpu", **kw)
    steps = 6
    jopt = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=4, total_steps=steps)
    popt = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=4, total_steps=steps)
    jtr = JTrainer(jcfg, jopt, JTrainerConfig(max_steps=steps, trace_stall=False,
                                              kernel_bags=kernel_bags),
                   embedding_store=jstore)
    jstate = jtr.init_state(0)
    pstate = _port_state(jstate)
    jtr.fit(iter(batches), jstate)
    ptr = Trainer(pcfg, popt, TrainerConfig(max_steps=steps, trace_stall=False,
                                            kernel_bags=kernel_bags),
                  embedding_store=pstore, device="cpu")
    out = ptr.fit(iter(batches), pstate)
    assert out["step"] == steps and len(ptr.history) == steps
    np.testing.assert_allclose(_losses(ptr), _losses(jtr), **GRAD_TOL)
    np.testing.assert_allclose([m.grad_norm for m in ptr.history],
                               [m.grad_norm for m in jtr.history], **GRAD_TOL)
    assert _stats(pstore) == _stats(jstore)
    assert (pstore.stats.kernel_bags > 0) == kernel_bags
    np.testing.assert_allclose(pstore.host_tables(), jstore.host_tables(),
                               rtol=1e-4, atol=1e-7)
    assert [m.hot_rate for m in ptr.history] == [m.hot_rate for m in jtr.history]
    snap = ptr.registry.snapshot()
    assert snap.values["train.steps"] == steps and "embed.hot_hits" in snap.values


def _dense_batches(cfg, n, bs=32, seed=0):
    # the reference's tests/test_trainer.py batches: labels a fixed linear
    # function of the dense features
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1234).normal(0, 1, cfg.num_dense).astype(np.float32)
    shape = (bs, cfg.num_tables, cfg.max_ids_per_feature)
    for _ in range(n):
        dense = rng.normal(0, 1, (bs, cfg.num_dense)).astype(np.float32)
        yield {
            "dense": dense,
            "sparse_ids": rng.integers(0, cfg.vocab_per_table, shape).astype(np.int32),
            "sparse_mask": np.ones(shape, np.float32),
            "label": (dense @ w > 0).astype(np.float32),
        }


def test_dense_trainer_matches_reference():
    steps = 6
    jopt = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=40)
    popt = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=40)
    jtr = JTrainer(J_SMOKE, jopt, JTrainerConfig(max_steps=steps))
    jstate = jtr.init_state(0)
    pstate = _port_state(jstate)
    jtr.fit(_dense_batches(J_SMOKE, steps), jstate)
    ptr = Trainer(SMOKE, popt, TrainerConfig(max_steps=steps), device="cpu")
    out = ptr.fit(_dense_batches(SMOKE, steps), pstate)
    assert out["step"] == steps and int(out["opt"]["step"]) == steps
    np.testing.assert_allclose(_losses(ptr), _losses(jtr), **GRAD_TOL)


def test_fit_decreases_loss():
    tr = Trainer(SMOKE, optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                              total_steps=40),
                 TrainerConfig(max_steps=40), device="cpu")
    state = tr.fit(_dense_batches(SMOKE, 40))
    losses = _losses(tr)
    assert losses[-1] < losses[0]
    assert state["step"] == 40


def test_stall_accounting():
    tr = Trainer(SMOKE, optim.OptimizerConfig(warmup_steps=1, total_steps=5),
                 TrainerConfig(max_steps=5), device="cpu")

    def slow():
        for b in _dense_batches(SMOKE, 5):
            time.sleep(0.05)
            yield b

    tr.fit(slow())
    assert tr.stall_fraction() > 0.05
    assert tr.embed_fetch_fraction() == 0.0


def test_train_cli_smoke_cpu(capsys):
    assert ptrain.main(["--smoke", "--steps", "25", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=dlrm-smoke device=cpu steps=25" in out


# -- the slice as a whole ------------------------------------------------------------


def _digest(batch) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _take_all(batches, session, n):
    try:
        return list(itertools.islice(batches, n))
    finally:
        session.stop()


def test_slice_dpp_to_tiered_trainer_matches_reference():
    """The port's dlrm_dpp_batches (torch engines on the CPU) feeding the
    port's tiered trainer with kernel_bags=True, against the reference's
    session and trainer at dlrm-smoke widths.  Workers race, so both
    sides train on the served batches in digest order; the served
    batches are the same multiset byte for byte."""
    rows, bs, steps = 512, 64, 12
    n = 2 * rows // bs
    jb, jsess = j_dlrm_dpp_batches(J_SMOKE, bs, rows_per_partition=rows)
    want = sorted(_take_all(jb, jsess, n), key=_digest)
    pb, psess = ptrain.dlrm_dpp_batches(SMOKE, bs, rows_per_partition=rows, device="cpu")
    got = sorted(_take_all(pb, psess, n), key=_digest)
    assert len(got) == len(want) == n
    assert [_digest(b) for b in got] == [_digest(b) for b in want]
    assert psess.worker_metrics().fused_features > 0

    kw = dict(seed=3, admit_reads=2)
    hot = SMOKE.vocab_per_table
    jstore = jcache.make_store_for_model(J_SMOKE, hot, **kw)
    pstore = make_store_for_model(SMOKE, hot, device="cpu", **kw)
    jopt = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=steps)
    popt = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=steps)
    jtr = JTrainer(J_SMOKE, jopt, JTrainerConfig(max_steps=steps, kernel_bags=True),
                   embedding_store=jstore)
    jstate = jtr.init_state(0)
    pstate = _port_state(jstate)
    jtr.fit(iter(want), jstate)
    ptr = Trainer(SMOKE, popt, TrainerConfig(max_steps=steps, kernel_bags=True),
                  embedding_store=pstore, device="cpu")
    ptr.fit(iter(got), pstate)
    np.testing.assert_allclose(_losses(ptr), _losses(jtr), **GRAD_TOL)
    assert np.isfinite(_losses(ptr)).all()
    assert pstore.stats.kernel_bags == jstore.stats.kernel_bags > 0
    assert _stats(pstore) == _stats(jstore)
