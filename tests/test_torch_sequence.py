"""The port's sequence parallelism (``parallel/sequence.py``) on the CPU
against the JAX package's.

In process: ``_chunk_mode`` and ``_ring_merge`` against JAX's.

One module-scoped fixture runs ONE four-process gloo job (this file run as
a script, once a rank, a ``file://`` store under tmp, ``OMP_NUM_THREADS=1``,
a timeout a process). Each case builds its seq group over ranks 0..n-1
(``cluster.build_named_groups``; all four ranks create every group) and
runs on seeded numpy inputs, each rank its (B, H, S/n, D) block:

- ``ring_flash_attention`` at n = 2 and 4, causal and not, f32 and bf16:
  out and lse (``ring_flash_fwd``) and dq, dk, dv (the Function's
  backward for a seeded cotangent), against JAX's ``ring_flash_attention``
  (and its ``_ring_flash_fwd_impl`` for lse) in interpret mode on the
  virtual ``seq`` mesh of n devices, as ``tests/test_sequence.py`` calls
  it, and against the port's plain flash forward and backward on the
  gathered sequence; and the plain calls a rank makes: a future block
  runs none (r + 1 forward and r + 1 backward calls on rank r under causal
  masking, n each without);
- ``ring_attention``'s block formulation at S/n = 12 (``pick_block``
  finds no tile), out and gradients against full attention;
- ``ulysses_attention``'s forward against JAX's on the same mesh, its
  gradients against full attention.

Tolerances: f32 rtol 1e-5, atol 1e-6 against JAX's ring in interpret mode
(the same per-block functions and the same f32 merge; the plain versions
sum a block's softmax in one pass where the Pallas kernels fold tiles) and
against the plain flash on the gathered sequence (the merge regroups the
sums); bf16 at rtol 2^-7 and an atol of 2^-7 of the largest magnitude
in the reference's ring block of each (batch, head), at least 1e-6 (a
row's own is too small a scale for a late key's dk, which few queries
feed), lse as f32: each block's out, dq, dk and dv come out of the flash
functions in bf16 and are summed in f32 (on both sides, as in JAX), so
an entry whose blocks nearly cancel may sit one bf16 rounding of a
block's value from the reference (measured: dq 6.1e-5 from JAX's ring
where the blocks' partials are ~0.01 and the sum ~0.001); the block
formulation and Ulysses at f32 rtol 1e-5, atol 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script: the rank workers
    sys.path.insert(0, REPO)

from poseidon_tpu_torch.ops import attention as port_attention  # noqa: E402
from poseidon_tpu_torch.ops import flash as port_flash  # noqa: E402
from poseidon_tpu_torch.parallel import sequence as port_seq  # noqa: E402
from poseidon_tpu_torch.runtime import cluster  # noqa: E402

WORLD = 4
B, H, D = 2, 4, 16
WORKER_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2 ** -7

# name -> (kind, n, causal, dtype, S/n)
CASES = {f"ring_n{n}_{'causal' if c else 'full'}_{dt}":
         ("ring", n, c, dt, 16)
         for n in (2, 4) for c in (True, False) for dt in ("f32", "bf16")}
CASES.update({f"block_n{n}_{'causal' if c else 'full'}":
              ("block", n, c, "f32", 12)
              for n, c in ((2, True), (2, False), (4, True))})
CASES.update({f"ulysses_n{n}_{'causal' if c else 'full'}":
              ("ulysses", n, c, "f32", 16)
              for n in (2, 4) for c in (True, False)})
RING_CASES = [c for c in CASES if CASES[c][0] == "ring"]
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(case):
    """Global q, k, v and the output's cotangent, (B, H, S, D) f32."""
    _, n, _, _, s_local = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case) + 7)
    return tuple((rs.randn(B, H, n * s_local, D) * 0.5).astype(np.float32)
                 for _ in range(4))


def _run_case(rank, case, d):
    kind, n, causal, dt, s_local = CASES[case]
    group = cluster.build_named_groups(("seq",), (n,), rank,
                                       torch.device("cpu"), "gloo",
                                       ranks=range(n))
    if group is None:           # outside this case's ranks
        return
    seq = group["seq"]
    with np.load(os.path.join(d, f"{case}.in.npz")) as z:
        q, k, v, g = (torch.from_numpy(z[x][:, :, rank * s_local:
                                            (rank + 1) * s_local])
                      .to(_DTYPES[dt]).contiguous() for x in "qkvg")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = port_seq.flash_attention_fwd, port_seq.flash_attention_bwd

    def counted_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    port_seq.flash_attention_fwd = counted_fwd
    port_seq.flash_attention_bwd = counted_bwd
    try:
        out = {}
        if kind == "ring":
            o, lse = port_seq.ring_flash_fwd(q, k, v, seq, causal)
            out["lse"] = lse.numpy()
            calls["fwd"] = 0
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn = {"ring": lambda *a: port_seq.ring_flash_attention(
                  *a, seq, causal),
              "block": lambda *a: port_seq.ring_attention(
                  *a, seq, causal=causal),
              "ulysses": lambda *a: port_seq.ulysses_attention(
                  *a, seq, causal=causal)}[kind]
        o = fn(*leaves)
        o.backward(g)
        out["out"] = o.detach().float().numpy()
        for name, t in zip(("dq", "dk", "dv"), leaves):
            out[name] = t.grad.float().numpy()
        out["fwd_calls"], out["bwd_calls"] = calls["fwd"], calls["bwd"]
    finally:
        port_seq.flash_attention_fwd, port_seq.flash_attention_bwd = fwd, bwd
    np.savez(os.path.join(d, f"{case}.rank{rank}.npz"), **out)


def _worker(rank: int, world: int, store: str, d: str) -> int:
    group = cluster.init_distributed(torch.device("cpu"), rank=rank,
                                     world=world,
                                     coordinator=f"file://{store}")
    try:
        for case in CASES:
            _run_case(rank, case, d)
    finally:
        group.close()
    return 0


if __name__ == "__main__":
    # a rank worker: it stops here, before the reference side's imports
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4]))


# --------------------------------------------------------------------- #
# the reference side

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from poseidon_tpu.compat import shard_map  # noqa: E402
from poseidon_tpu.parallel import sequence as jax_seq  # noqa: E402
from poseidon_tpu.parallel.mesh import make_mesh  # noqa: E402


@pytest.fixture(scope="module")
def seq_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    for case in CASES:
        np.savez(d / f"{case}.in.npz", **dict(zip("qkvg", _inputs(case))))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(d / "store"), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        # JAX's references while the ranks run
        jax_refs = {case: _jax_ring(case) for case in RING_CASES}
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    results = {}
    for case, (_, n, _, _, _) in CASES.items():
        results[case] = []
        for r in range(n):
            with np.load(d / f"{case}.rank{r}.npz") as z:
                results[case].append({k: z[k] for k in z.files})
    return results, jax_refs


def _gathered(ranks, key):
    """The ranks' blocks of ``key`` along the sequence axis."""
    return np.concatenate([r[key] for r in ranks], axis=2)


def _assert_ring_close(got, ref, dt, n, msg):
    """f32's tolerance, or bf16's: rtol 2^-7 and an atol of 2^-7 of the
    largest magnitude in ``ref``'s ring block of each (batch, head) (a
    rank's S/n rows of the gathered (B, H, S, D): the blocks' roundings,
    and delta's from the merged bf16 output), at least f32's."""
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        return
    b, h, s, d = ref.shape
    scale = np.abs(ref).reshape(b, h, n, s // n * d).max(axis=-1)
    atol = np.maximum(ATOL, BF16_RTOL
                      * np.repeat(scale, s // n, axis=-1)[..., None])
    over = np.abs(got - ref) - (atol + BF16_RTOL * np.abs(ref))
    assert over.max() <= 0, (f"{msg}: {int((over > 0).sum())} entries "
                             f"outside, worst by {over.max():.3e}")


def _jax_ring(case):
    """JAX's (out, lse, dq, dk, dv) on the virtual seq mesh of n devices,
    its ring flash in interpret mode, as numpy f32."""
    _, n, causal, dt, s_local = CASES[case]
    q, k, v, g = (jnp.asarray(x, jnp.float32 if dt == "f32"
                              else jnp.bfloat16) for x in _inputs(case))
    mesh = make_mesh(num_devices=n, axes=("seq",))
    block = s_local
    spec = P(None, None, "seq")

    def local(q, k, v, g):
        out, lse = jax_seq._ring_flash_fwd_impl(q, k, v, "seq", causal,
                                                None, block, True)
        _, vjp = jax.vjp(lambda q, k, v: jax_seq.ring_flash_attention(
            q, k, v, "seq", causal, None, block, True), q, k, v)
        return (out, lse, *vjp(g))

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) * 4,
                           out_specs=(spec, P(None, None, "seq"),
                                      spec, spec, spec),
                           check_vma=False))
    return tuple(np.asarray(x.astype(jnp.float32)) for x in fn(q, k, v, g))


def _plain_full(case):
    """The port's plain flash forward and backward on the gathered
    sequence: (out, lse, dq, dk, dv) as numpy f32."""
    _, _, causal, dt, _ = CASES[case]
    q, k, v, g = (torch.from_numpy(x).to(_DTYPES[dt])
                  for x in _inputs(case))
    out, lse = port_flash.flash_attention_fwd_plain(q, k, v, causal)
    grads = port_flash.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                 causal)
    return tuple(t.float().numpy() for t in (out, lse, *grads))


def _dense_full(case):
    """``ops/attention.attention`` and its autograd gradients on the
    gathered sequence, as numpy."""
    _, _, causal, _, _ = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(case))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port_attention.attention(*leaves, causal=causal)
    out.backward(g)
    return (out.detach().numpy(), *(t.grad.numpy() for t in leaves))


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_mode_matches_jax(causal):
    for my in range(4):
        for src in range(4):
            want = int(jax_seq._chunk_mode(jnp.int32(my), jnp.int32(src),
                                           causal))
            assert port_seq._chunk_mode(my, src, causal) == want


def test_ring_merge_matches_jax():
    """Three blocks folded in turn, one of them dead (lse NEG_INF) and
    one far below the others, from numpy inputs."""
    rs = np.random.RandomState(3)
    shape = (2, 3, 8)
    blocks = [((rs.randn(*shape, 4)).astype(np.float32),
               (rs.randn(*shape) * 3).astype(np.float32)) for _ in range(3)]
    blocks[1] = (blocks[1][0], np.full(shape, -1e30, np.float32))
    blocks[2] = (blocks[2][0], blocks[2][1] - 80.0)
    jacc = np.zeros((*shape, 4), np.float32)
    jm, jl = np.full(shape, -1e30, np.float32), np.zeros(shape, np.float32)
    pacc, pm, pl = (torch.from_numpy(x.copy()) for x in (jacc, jm, jl))
    jstate = (jnp.asarray(jacc), jnp.asarray(jm), jnp.asarray(jl))
    for o, lse in blocks:
        jstate = jax_seq._ring_merge(*jstate, jnp.asarray(o),
                                     jnp.asarray(lse))
        pacc, pm, pl = port_seq._ring_merge(pacc, pm, pl,
                                            torch.from_numpy(o),
                                            torch.from_numpy(lse))
    for got, want in zip((pacc, pm, pl), jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_flash_matches_jax_and_full_attention(seq_run, case):
    results, jax_refs = seq_run
    dt = CASES[case][3]
    got = [_gathered(results[case], key) for key in ("out", "lse", "dq",
                                                     "dk", "dv")]
    for ref_name, ref in (("JAX ring", jax_refs[case]),
                          ("plain, gathered", _plain_full(case))):
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
            _assert_ring_close(a, b, "f32" if name == "lse" else dt,
                               CASES[case][1], f"{name} vs {ref_name}")


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_flash_runs_no_plain_call_for_a_dead_block(seq_run, case):
    """Rank r of n calls the flash functions r + 1 times a direction under
    causal masking (its past blocks and the diagonal), n times without."""
    _, n, causal, _, _ = CASES[case]
    for r, res in enumerate(seq_run[0][case]):
        want = r + 1 if causal else n
        assert int(res["fwd_calls"]) == want, (r, res["fwd_calls"])
        assert int(res["bwd_calls"]) == want, (r, res["bwd_calls"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "block"])
def test_ring_block_formulation_matches_full_attention(seq_run, case):
    """S/n = 12: ``pick_block`` finds no tile, so ``ring_attention`` runs
    the block formulation; no flash call is made."""
    ranks = seq_run[0][case]
    got = [_gathered(ranks, key) for key in ("out", "dq", "dk", "dv")]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          _dense_full(case)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    assert all(int(r["fwd_calls"]) == int(r["bwd_calls"]) == 0
               for r in ranks)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "ulysses"])
def test_ulysses_matches_jax_and_full_attention(seq_run, case):
    _, n, causal, _, _ = CASES[case]
    ranks = seq_run[0][case]
    q, k, v, _ = (jnp.asarray(x) for x in _inputs(case))
    spec = P(None, None, "seq")
    jfn = jax.jit(shard_map(
        functools.partial(jax_seq.ulysses_attention, axis="seq",
                          causal=causal),
        mesh=make_mesh(num_devices=n, axes=("seq",)),
        in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
    np.testing.assert_allclose(_gathered(ranks, "out"),
                               np.asarray(jfn(q, k, v)), rtol=RTOL,
                               atol=ATOL)
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          [_gathered(ranks, key)
                           for key in ("out", "dq", "dk", "dv")],
                          _dense_full(case)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_ulysses_refuses_heads_that_do_not_divide():
    from poseidon_tpu_torch.parallel.mesh import DataGroup
    group = DataGroup(rank=0, world=3, device=torch.device("cpu"))
    x = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match=r"heads \(4\) must divide by axis "
                                         r"size \(3\)"):
        port_seq.ulysses_attention(x, x, x, group)
