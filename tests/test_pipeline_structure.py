"""Structural proof of the pipelined a2a engine's comm/compute overlap.

A CPU mesh cannot *show* latency hiding — but the property the
latency-hiding scheduler
needs is purely structural: chunk c's return all-to-all must be data-
independent of every other chunk's local gather and return exchange, and
all id exchanges must be issued before any return work.  That structure is
visible in the traced jaxpr, which XLA's scheduler receives dependency-
faithfully.  These tests verify it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.parallel.embedding_sharding import (
    shard_table,
    sharded_gather_a2a_pipelined,
)
from recsys_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh_4x2():
    assert len(jax.devices()) >= 8
    return make_mesh(data=4, model=2)


def _walk_eqns(jaxpr, out=None):
    """All eqns of a jaxpr, recursing into sub-jaxprs (shard_map, pjit...)."""
    if out is None:
        out = []
    for eqn in jaxpr.eqns:
        out.append(eqn)
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                _walk_eqns(sub if hasattr(sub, "eqns") else sub.jaxpr, out)
            elif hasattr(v, "eqns"):
                _walk_eqns(v, out)
    return out


def _transitive_dep_eqns(target, eqns):
    """Indices of eqns the target eqn transitively depends on."""
    producer = {}
    for idx, eqn in enumerate(eqns):
        for ov in eqn.outvars:
            producer[id(ov)] = idx
    seen, stack = set(), [id(v) for v in target.invars if hasattr(v, "aval")]
    deps = set()
    while stack:
        vid = stack.pop()
        if vid in seen:
            continue
        seen.add(vid)
        idx = producer.get(vid)
        if idx is None:
            continue
        deps.add(idx)
        for v in eqns[idx].invars:
            if hasattr(v, "aval"):
                stack.append(id(v))
    return deps


def _a2a_structure(num_chunks, mesh):
    table = jnp.zeros((64, 8), jnp.float32)
    rows = jnp.zeros((8, 6), jnp.int32)

    def fn(t, r):
        return sharded_gather_a2a_pipelined(t, r, mesh, num_chunks=num_chunks)

    jaxpr = jax.make_jaxpr(fn)(table, rows)
    eqns = _walk_eqns(jaxpr.jaxpr)
    a2a_idx = [
        i for i, e in enumerate(eqns) if e.primitive.name == "all_to_all"
    ]
    return eqns, a2a_idx


@pytest.mark.parametrize("k", [2, 4])
def test_pipelined_a2a_collective_count_and_phase_order(mesh_4x2, k):
    eqns, a2a_idx = _a2a_structure(k, mesh_4x2)
    # one id exchange + one vector return exchange per chunk
    assert len(a2a_idx) == 2 * k
    # phase A up front: in trace order, the k id exchanges all precede the
    # k return exchanges
    id_xs, ret_xs = a2a_idx[:k], a2a_idx[k:]
    assert max(id_xs) < min(ret_xs)


@pytest.mark.parametrize("k", [2, 4])
def test_pipelined_a2a_chunks_are_data_independent(mesh_4x2, k):
    """Chunk c's return exchange depends on its OWN id exchange only —
    never on another chunk's gather or return exchange.  This is the
    independent-collective structure XLA's latency-hiding scheduler needs
    to overlap chunk c's return comm with chunk c+1's gather compute."""
    eqns, a2a_idx = _a2a_structure(k, mesh_4x2)
    id_xs, ret_xs = a2a_idx[:k], a2a_idx[k:]
    for c, r in enumerate(ret_xs):
        deps = _transitive_dep_eqns(eqns[r], eqns)
        dep_id_exchanges = [i for i in id_xs if i in deps]
        dep_ret_exchanges = [i for i in ret_xs if i in deps]
        assert dep_id_exchanges == [id_xs[c]], (
            f"return exchange {c} depends on id exchanges "
            f"{dep_id_exchanges}, expected only its own"
        )
        assert dep_ret_exchanges == [], (
            f"return exchange {c} depends on return exchanges "
            f"{dep_ret_exchanges}; chunks must be independent"
        )


def test_pipelined_a2a_still_correct_after_structure_checks(mesh_4x2):
    # the structural property must not have cost correctness
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(64, 8)), jnp.float32)
    rows = jnp.asarray(rng.integers(0, 64, (8, 6)), jnp.int32)
    t = shard_table(table, mesh_4x2)
    got = sharded_gather_a2a_pipelined(
        t, rows, mesh_4x2, num_chunks=4, capacity_factor=None
    )
    np.testing.assert_allclose(got, jnp.take(table, rows, axis=0), rtol=1e-6)
