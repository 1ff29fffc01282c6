"""The sparse DLRM step's row-wise AdaGrad table update
(``ops.rowwise_adagrad_``, ``DLRM.sparse_table_update_``).

On the CPU the update is the plain scatter-adds; those tests hold the
port's one-rank update on ``torch_sharded_ref.edge_inputs``' cases (pads
on row 0, one row named 10,000 times, an all-pad bag, the last row of the
last table, a d(pooled) row holding a NaN, lr as a 0-d tensor) to the
reference's ``sparse_table_update`` (the sharded form's are in
``tests/test_torch_dlrm_sharded.py``, tag "edge").  JAX is imported
inside them, so the file also runs on a card machine without JAX, where
they skip and the card tests (marker ``cuda``) run:

    PYTHONPATH=src python -m pytest tests/test_torch_rowwise_adagrad.py -m cuda -q

On the card the update is the ``rowwise_adagrad`` kernel, held to the
plain version within ``CARD_TOL``: both sum the same float32 terms in
another order (the plain version's ``index_add_`` atomics take theirs
from the hardware), a row's accumulator over up to ~10^4 occurrences, so
n u ~ 6e-4 in the worst case and ~1e-5 as the errors fall.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import torch_sharded_ref as R  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import rowwise_adagrad as kadagrad  # noqa: E402
from repro_torch.launch.mesh import VirtualMesh  # noqa: E402
from repro_torch.launch.steps import make_dlrm_sparse_train_step  # noqa: E402
from repro_torch.models.dlrm import DLRM  # noqa: E402

SMOKE = dataclasses.replace(configs.get_smoke_config("dlrm-paper"), vocab_per_table=R.VOCAB)
# dlrm-paper's widths (42 tables, 32 slots a bag, E 128), the vocab cut
PAPER = dataclasses.replace(configs.get_config("dlrm-paper"), vocab_per_table=20_000)
LR = 0.05
# the kernel against the plain version: each row's change within this
# share of the largest change, each accumulator entry within this rtol
CARD_TOL = 1e-4


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the plain route on the CPU against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref():
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import build_model

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("dlrm-paper"), vocab_per_table=R.VOCAB)
    return jax, build_model(jcfg)


@pytest.mark.parametrize("case", R.EDGE_CASES)
def test_one_rank_update_matches_reference(jax_ref, case):
    """``DLRM.sparse_table_update`` (keys, bags and weights through
    ``ops.rowwise_adagrad_``'s plain route) against the reference's
    ``sparse_table_update``, NaN where it puts NaN; "all" passes lr as a
    0-d tensor."""
    jax, jmodel = jax_ref
    x = R.edge_inputs(SMOKE, case)
    lr = torch.tensor(LR) if case == "all" else LR
    want_t, want_a = jax.jit(jmodel.sparse_table_update)(
        x["tables"], x["acc"], x["dpooled"], x, np.float32(LR))
    model = DLRM(SMOKE, tables=False, device="cpu")
    xt = _t(x)
    got_t, got_a = model.sparse_table_update(xt["tables"], xt["acc"], xt["dpooled"], xt, lr)
    # XLA's scatter and index_add_ add a row's occurrences (up to 10^4) in
    # their own orders: a few ulps of the tables' 0.5 scale
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-7)
    assert np.array_equal(xt["tables"].numpy(), x["tables"])      # the inputs are kept
    if case in ("nan_bag", "all"):
        assert np.isnan(got_t.numpy()[4, [0, 11]]).all() and np.isnan(got_a.numpy()[4, [0, 11]]).all()
        assert not np.isnan(got_t.numpy()[4, 12:]).any()
    if case in ("hot_row", "all"):
        hot = SMOKE.vocab_per_table // 2 + 3
        assert not np.array_equal(got_t.numpy()[3, hot], x["tables"][3, hot])


def test_kernel_wrapper_refuses_what_it_cannot_take():
    table, acc = torch.zeros((8, 16)), torch.zeros(8)
    keys, w, g = torch.zeros((2, 3), dtype=torch.int32), torch.ones((2, 3)), torch.ones((2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kadagrad.rowwise_adagrad_(table, acc, keys, w, g, LR)


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _zipf_batch(cfg, b, seed, live=0.17):
    """Zipf (a = 1.3) ids spread over the vocab, each bag's first slots
    live (17% of them on average) and the rest pads (id 0, mask 0), as the
    DPP session's batches are."""
    rng = np.random.default_rng(seed)
    t, l, v = cfg.num_tables, cfg.max_ids_per_feature, cfg.vocab_per_table
    ids = ((rng.zipf(1.3, (b, t, l)) * 2654435761) % v).astype(np.int32)
    n_live = rng.integers(0, int(2 * live * l) + 1, (b, t, 1))
    mask = (np.arange(l)[None, None, :] < n_live).astype(np.float32)
    ids[mask == 0] = 0
    return {"sparse_ids": ids, "sparse_mask": mask}


def _state(cfg, b, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    t, v, e = cfg.num_tables, cfg.vocab_per_table, cfg.embed_dim
    tables = 0.02 * torch.randn((t, v, e), generator=g, device=device)
    acc = 1e-3 * torch.rand((t, v), generator=g, device=device)
    dpooled = 1e-2 * torch.randn((b, t, e), generator=g, device=device)
    return tables, acc, dpooled


def _both(cfg, batch, tables, acc, dpooled, lr):
    """(kernel's tables, acc), (plain's tables, acc) from one state."""
    model = DLRM(cfg, tables=False, device=tables.device)
    keys, w = model._update_operands(batch, 0, cfg.vocab_per_table)
    e = cfg.embed_dim
    got = ops.rowwise_adagrad_(tables.clone().view(-1, e), acc.clone().view(-1), keys, w,
                               dpooled.reshape(-1, e), lr)
    want = ref.rowwise_adagrad_(tables.clone().view(-1, e), acc.clone().view(-1), keys, w,
                                dpooled.reshape(-1, e), lr)
    return got, want


def _assert_close(got, want, before):
    (gt, ga), (wt, wa) = got, want
    assert torch.equal(torch.isnan(gt), torch.isnan(wt))
    assert torch.equal(torch.isnan(ga), torch.isnan(wa))
    ok = ~torch.isnan(wt)
    change = (wt - before)[ok].abs().max()
    assert float((gt - wt)[ok].abs().max()) <= CARD_TOL * float(change)
    oka = ~torch.isnan(wa)
    assert torch.allclose(ga[oka], wa[oka], rtol=CARD_TOL, atol=0)


@pytest.mark.cuda
def test_kernel_matches_plain_at_dlrm_widths(cuda):
    """42 tables, 32 slots, E 128, Zipf-hot rows and 83% pads, lr a 0-d
    tensor on the card."""
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _zipf_batch(PAPER, 1024, 1).items()}
    tables, acc, dpooled = _state(PAPER, 1024, 2, cuda)
    got, want = _both(PAPER, batch, tables, acc, dpooled, torch.tensor(LR, device=cuda))
    torch.cuda.synchronize()
    _assert_close(got, want, tables.view(-1, PAPER.embed_dim))
    assert not torch.equal(got[0], tables.view(-1, PAPER.embed_dim))


@pytest.mark.cuda
def test_kernel_is_bit_identical_from_run_to_run(cuda):
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _zipf_batch(PAPER, 1024, 3).items()}
    tables, acc, dpooled = _state(PAPER, 1024, 4, cuda)
    a, _ = _both(PAPER, batch, tables, acc, dpooled, LR)
    b, _ = _both(PAPER, batch, tables, acc, dpooled, LR)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", R.EDGE_CASES)
def test_kernel_edge_inputs_match_plain(cuda, case):
    """``edge_inputs``' cases at smoke widths (E 16: four lanes a row):
    NaN exactly where the plain version puts it."""
    x = {k: torch.from_numpy(v).to(cuda) for k, v in R.edge_inputs(SMOKE, case).items()}
    got, want = _both(SMOKE, x, x["tables"], x["acc"], x["dpooled"], LR)
    torch.cuda.synchronize()
    _assert_close(got, want, x["tables"].view(-1, SMOKE.embed_dim))
    if case in ("nan_bag", "all"):
        assert torch.isnan(got[0].view(SMOKE.num_tables, -1, SMOKE.embed_dim)[4, 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("times", [1, 31, 32, 33, 64, 65, 1000, 10_000, 4096 * 32])
def test_kernel_runs_longer_than_a_chunk(cuda, times):
    """One row named ``times`` times among Zipf traffic, from 1 to every
    slot of a table (4096 chunks of 32), with an offset so the run crosses
    chunk edges at another place."""
    cfg = PAPER
    x = _zipf_batch(cfg, 4096, 5)
    flat_ids = x["sparse_ids"][:, 7].reshape(-1)
    flat_mask = x["sparse_mask"][:, 7].reshape(-1)
    at = np.arange(times) + 3 if times < flat_ids.size else np.arange(times)
    flat_ids[at], flat_mask[at] = 777, 1.0
    x["sparse_ids"][:, 7] = flat_ids.reshape(4096, -1)
    x["sparse_mask"][:, 7] = flat_mask.reshape(4096, -1)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in x.items()}
    tables, acc, dpooled = _state(cfg, 4096, 6, cuda)
    got, want = _both(cfg, batch, tables, acc, dpooled, LR)
    torch.cuda.synchronize()
    _assert_close(got, want, tables.view(-1, cfg.embed_dim))


@pytest.mark.cuda
def test_kernel_tally_counts_occurrences_and_rows(cuda):
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _zipf_batch(PAPER, 512, 7).items()}
    tables, acc, dpooled = _state(PAPER, 512, 8, cuda)
    model = DLRM(PAPER, tables=False, device=cuda)
    keys, w = model._update_operands(batch, 0, PAPER.vocab_per_table)
    live = keys[w != 0]
    kadagrad.TALLY.reset()
    model.sparse_table_update_(tables, acc, dpooled, batch, LR)
    counts = kadagrad.TALLY.snapshot()[str(tables.device)]
    assert counts == {"occurrences": live.numel(), "rows": int(torch.unique(live).numel())}


@pytest.mark.cuda
def test_sparse_step_launches_the_kernel_once_and_never_syncs(cuda):
    """Three steps of the one-rank sparse step at dlrm-paper's widths (vocab
    cut): ``rowwise_adagrad`` launched once a step; the table update runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    host synchronisation, and allocates no per-slot (N, E) tensor."""
    mesh = VirtualMesh((1, 1), ("data", "model"), device=cuda)
    b = 1024
    bundle = make_dlrm_sparse_train_step(PAPER, mesh, b, device="cuda")
    params, opt = bundle.init_state(0)
    model = bundle.model
    update = model.sparse_table_update_sharded_
    peaks = []

    def guarded(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        torch.cuda.set_sync_debug_mode("error")
        try:
            update(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - before)

    model.sparse_table_update_sharded_ = guarded
    rng = np.random.default_rng(9)
    for i in range(3):
        x = _zipf_batch(PAPER, b, 10 + i)
        x["dense"] = rng.normal(0, 1, (b, PAPER.num_dense)).astype(np.float32)
        x["label"] = (rng.random(b) < 0.5).astype(np.float32)
        before = build.LAUNCHES.snapshot().get("rowwise_adagrad", 0)
        params, opt, met = bundle.fn(params, opt, bundle.shard_batch(x))
        assert np.isfinite(float(met["loss"]))
        assert build.LAUNCHES.snapshot()["rowwise_adagrad"] == before + 1
    slot_grad = b * PAPER.num_tables * PAPER.max_ids_per_feature * PAPER.embed_dim * 4
    assert len(peaks) == 3 and max(peaks) < slot_grad / 4, (peaks, slot_grad)
