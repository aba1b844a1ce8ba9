"""The port's process-group mesh (``parallel.mesh``), launcher
(``parallel.launch``), multi-host scaffolding (``parallel.distributed``),
the distributed SPIKE band solve (``solver.banded``) and the sharded
checkpoint write (``io.save_solver_state(mesh=...)``), on gloo ranks on the
CPU:

- ``psum``, ``pmax``, ``allgather`` and ``ppermute`` (cyclic pairs both
  ways, a shift by two, one receiver, self pairs, a self pair beside a
  send, packed lists) against numpy at n = 2 (the world's pairs of ranks
  as groups of their own) and n = 4 (the world); every rank of a group
  reads the same bits;
- SPIKE at (n, sb, B, R) in {(2, 3, 5, 2), (4, 2, 7, 1)} against the JAX
  package's ``spike_block_tridiag_solve`` at the same n on its CPU mesh
  (rtol 1e-9, atol 1e-10, as ``tests/test_banded.py``);
- ``distributed`` inside a running group and as the single-process no-op,
  ``process_local_rows``; the checkpoint written once under two ranks and
  read back; a failing rank's traceback raised by ``run_spmd``.

One 4-rank world runs every rank-side check (``torch_spmd_ranks.
mesh_world``), in a thread beside the JAX package's SPIKE compiles."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_spmd_ranks as ranks
from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.solver.banded import spike_block_tridiag_solve as jax_spike
from kontiki_tpu_torch.parallel import Mesh, distributed, launch

SPIKE_CASES = {2: (2, 3, 5, 2), 4: (4, 2, 7, 1)}


def _system(n, sb, B, R, seed):
    """A random SPD block-tridiagonal system of n sb blocks (the JAX
    package's test construction)."""
    rng = np.random.default_rng(seed)
    nb = n * sb
    U = rng.normal(size=(nb, B, B)) * 0.3
    U[-1] = 0.0
    D = np.stack([np.eye(B) * (B + 2.0) for _ in range(nb)])
    D += np.stack([a @ a.T for a in rng.normal(size=(nb, B, B))]) * 0.1
    return D, U, rng.normal(size=(nb, B, R))


def _jax_spike(n, system):
    mesh = jax_parallel.default_mesh(n_devices=n)
    axis = jax_parallel.MEASUREMENT_AXIS
    sm = jax.jit(jax.shard_map(lambda d, u, r: jax_spike(d, u, r, axis, n), mesh=mesh,
                               in_specs=(P(axis), P(axis), P(axis)), out_specs=P(axis),
                               check_vma=False))
    return np.asarray(sm(*(jnp.asarray(a) for a in system)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    systems = {n: _system(*case, seed=n) for n, case in SPIKE_CASES.items()}
    path = str(tmp_path_factory.mktemp("ckpt") / "state_{}.h5")
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch.run_spmd, ranks.mesh_world, 4, "cpu", systems, path)
        want = {n: _jax_spike(n, systems[n]) for n in SPIKE_CASES}
        return dict(outs=run.result(), systems=systems, want=want)


def _group_outs(world, n):
    """(group key, [(ranks of a group, their outputs)]) at n shards."""
    if n == 4:
        return "world", [(list(range(4)), world["outs"])]
    return "pair", [(p, [world["outs"][r] for r in p]) for p in ([0, 1], [2, 3])]


def _expected_ppermute(values, pairs, rank):
    src = [s for s, d in pairs if d == rank]
    return values[src[0]] if src else torch.zeros_like(values[0])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("what", ["psum", "pmax", "psum_list", "allgather"])
def test_reductions_match_numpy(world, n, what):
    key, groups = _group_outs(world, n)
    for members, outs in groups:
        vals = [ranks.rank_value(i) for i in range(len(members))]
        want = {"psum": sum(vals[1:], vals[0]), "pmax": torch.stack(vals).amax(0),
                "allgather": torch.cat(vals)}
        for o in outs:
            got = o[key][what]
            assert o[key]["size"] == n
            if what == "psum_list":
                np.testing.assert_allclose(got[0].numpy(), want["psum"].numpy(), rtol=1e-14)
                np.testing.assert_allclose(got[1].item(), 2.0 * sum(v[0, 0].item() for v in vals),
                                           rtol=1e-14)
            elif what == "pmax" or what == "allgather":
                assert torch.equal(got, want[what])
            else:
                np.testing.assert_allclose(got.numpy(), want[what].numpy(), rtol=1e-14)
        # every rank of the group reads the same bits
        first = outs[0][key][what]
        for o in outs[1:]:
            other = o[key][what]
            if isinstance(first, list):
                assert all(torch.equal(a, b) for a, b in zip(first, other))
            else:
                assert torch.equal(first, other)


@pytest.mark.parametrize("n,case", [(n, c) for n in (2, 4)
                                    for c in sorted(ranks.pairs_cases(n)) + ["list"]])
def test_ppermute_matches_jax_semantics(world, n, case):
    """A shard gets its source's value, zeros without one; a self pair
    copies; cyclic pairs wrap; packed lists split back."""
    key, groups = _group_outs(world, n)
    cases = ranks.pairs_cases(n)
    for members, outs in groups:
        vals = [ranks.rank_value(i) for i in range(len(members))]
        for i, o in enumerate(outs):
            if case == "list":
                pairs = cases["cyclic right"]
                got = o[key]["ppermute list"]
                src = _expected_ppermute(vals, pairs, i)
                assert torch.equal(got[0], src) and torch.equal(got[1], src[:, 0])
            else:
                assert torch.equal(o[key][f"ppermute {case}"],
                                   _expected_ppermute(vals, cases[case], i)), (case, i)


@pytest.mark.parametrize("n", [2, 4])
def test_spike_matches_jax(world, n):
    _, sb, B, R = SPIKE_CASES[n]
    want = world["want"][n]
    key, groups = _group_outs(world, n)
    for members, outs in groups:
        got = torch.cat([o[f"spike {n}"] for o in outs]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
        assert got.shape == (n * sb, B, R)


def test_distributed_inside_a_group(world):
    for r, o in enumerate(world["outs"]):
        d = o["distributed"]
        assert d["initialize"] and d["is_multiprocess"]
        assert d["global_mesh"] == (r, 4)
        assert d["rows"] == (min(3 * r, 10), min(3 * (r + 1), 10))


def test_distributed_single_process_is_a_no_op(monkeypatch):
    for var in ("KONTIKI_DISTRIBUTED", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_multiprocess()
    assert distributed.process_local_rows(10) == (0, 10)
    m = distributed.global_mesh("cpu")
    assert (m.rank, m.size, m.group) == (0, 1, None)


def test_one_shard_mesh_is_the_identity():
    m = Mesh()
    x = ranks.rank_value(0)
    assert m.psum(x) is x and m.pmax(x) is x and m.allgather(x) is x
    assert torch.equal(m.ppermute(x, [(0, 0)]), x)
    assert torch.equal(m.ppermute(x, []), torch.zeros_like(x))
    assert m.axis_index() == 0 and m.transport == "in-process copy"
    with pytest.raises(ValueError):
        m.ppermute(x, [(0, 1)])


def test_checkpoint_written_once_and_read_back(world):
    for members in ([0, 1], [2, 3]):
        outs = [world["outs"][r]["io"] for r in members]
        assert [o["writes"] for o in outs] == [1, 0]
        for o in outs:
            assert o["meta"] == {"iteration": 7, "trust_region_radius": 2.5}
            assert torch.equal(o["state"]["r3"], torch.arange(12.0, dtype=torch.float64)
                               .reshape(4, 3))
            assert torch.equal(o["state"]["rho"],
                               torch.linspace(0.5, 1.5, 5, dtype=torch.float64))


def test_launcher_choices():
    assert launch.backend_for("cpu", 4) == "gloo"
    assert launch.backend_for("cuda:0", 4) == "gloo"
    assert launch.backend_for("cuda:0", 1) == "nccl"
    assert launch.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert launch.rank_device("cpu", 3) == torch.device("cpu")


def test_failing_rank_raises_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*on purpose"):
        launch.run_spmd(ranks.failing, 2, "cpu", timeout=60.0)
