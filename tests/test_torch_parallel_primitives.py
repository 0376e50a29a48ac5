"""The pipeline, expert and ring-attention primitives of the port
(``parallel/{pipeline,experts,ring_attention}.py``) against the JAX
package's on the CPU, on the cases of ``tests/test_parallel.py``.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces (marked ``mesh``); the port's shards run on the CPU
(``shard_devices("cpu", n)``).  Floats at rtol 2e-4 / atol 1e-5, against
JAX and against the dense versions; MoE's integer routing (choice,
position, keep) exact.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.parallel import (experts, make_expert_mesh,
                                              make_pipe_mesh, make_seq_mesh,
                                              moe_apply, pipeline_apply,
                                              ring_attention,
                                              stack_stage_params)
from cluster_tools_tpu_torch.parallel.mesh import shard_devices

RTOL, ATOL = 2e-4, 1e-5


def _devs(n=8):
    return shard_devices("cpu", n)


def _stage_np(p, a):
    return np.tanh(a @ p["w"] + p["b"])


@pytest.mark.mesh
@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (2, 1), (8, 3)])
def test_pipeline_apply_matches_jax(n_stages, n_micro):
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel import pipeline as jp

    d = 8
    rng = np.random.RandomState(n_stages)
    per = [{"w": rng.randn(d, d).astype("float32") * 0.3,
            "b": rng.randn(d).astype("float32")} for _ in range(n_stages)]
    x = rng.randn(n_micro, 3, d).astype("float32")
    want = np.asarray(jp.pipeline_apply(
        lambda p, a: jnp.tanh(a @ p["w"] + p["b"]),
        jp.stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                               for p in per]),
        jnp.asarray(x), jp.make_pipe_mesh(n_stages, 8), axis="pipe"))
    mesh = make_pipe_mesh(n_stages, devices=_devs())
    assert mesh.shape == {"pipe": n_stages, "data": 8 // n_stages}
    params = stack_stage_params([{k: torch.from_numpy(v)
                                  for k, v in p.items()} for p in per])
    assert params["w"].shape == (n_stages, d, d)
    got = pipeline_apply(lambda p, a: torch.tanh(a @ p["w"] + p["b"]),
                         params, torch.from_numpy(x), mesh).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    expect = x
    for p in per:
        expect = _stage_np(p, expect)
    np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)


def test_pipeline_single_microbatch_and_scalars():
    mesh = make_pipe_mesh(2, devices=_devs())
    params = stack_stage_params([{"s": torch.tensor(2.0)},
                                 {"s": torch.tensor(3.0)}])
    out = pipeline_apply(lambda p, a: a * p["s"], params,
                         torch.ones((1, 4)), mesh)
    np.testing.assert_allclose(out.numpy(), 6.0 * np.ones((1, 4)))
    with pytest.raises(ValueError, match="stages"):
        make_pipe_mesh(3, devices=_devs())


def _jax_moe(w, logits, tokens, capacity):
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel import experts as je

    n = w.shape[0]
    return np.asarray(je.moe_apply(
        lambda p, x: x @ p["w"], {"w": jnp.asarray(w)},
        jnp.asarray(logits), jnp.asarray(tokens),
        je.make_expert_mesh(n, 8), axis="expert", capacity=capacity))


def _jax_route(logits, capacity):
    """The JAX program's routing of one shard (its ``body``, verbatim)."""
    import jax
    import jax.numpy as jnp

    n = logits.shape[1]
    t = logits.shape[0]
    choice = jnp.argmax(logits, axis=1)
    onehot = jax.nn.one_hot(choice, n, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - 1)[jnp.arange(t), choice]
    return np.asarray(choice), np.asarray(pos), np.asarray(pos < capacity)


def _port_moe(w, logits, tokens, capacity):
    mesh = make_expert_mesh(w.shape[0], devices=_devs())
    return moe_apply(lambda p, x: x @ p["w"], {"w": torch.from_numpy(w)},
                     torch.from_numpy(logits), torch.from_numpy(tokens),
                     mesh, capacity=capacity).numpy()


@pytest.mark.mesh
@pytest.mark.parametrize("case", ["ample", "default", "overflow", "ties"])
def test_moe_apply_matches_jax(case):
    n, t_local, d = 8, 16, 4
    rng = np.random.RandomState(1)
    tokens = rng.randn(n * t_local, d).astype("float32")
    logits = rng.randn(n * t_local, n).astype("float32")
    w = (rng.randn(n, d, d) * 0.5).astype("float32")
    capacity = {"ample": t_local, "default": 0, "overflow": 1,
                "ties": 2}[case]
    if case == "ties":  # equal maxima: the first expert wins in both
        logits[:, 3] = logits[:, 5] = logits.max(1) + 1.0
    got = _port_moe(w, logits, tokens, capacity)
    want = _jax_moe(w, logits, tokens, capacity)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    cap = capacity or -(-t_local // n)
    for j in range(n):
        sl = slice(j * t_local, (j + 1) * t_local)
        c, p, k, _ = experts.route(torch.from_numpy(logits[sl]), cap)
        jc, jpos, jk = _jax_route(logits[sl], cap)
        np.testing.assert_array_equal(c.numpy(), jc)
        np.testing.assert_array_equal(p.numpy(), jpos)
        np.testing.assert_array_equal(k.numpy(), jk)
        # overflow tokens pass through bit for bit
        np.testing.assert_array_equal(got[sl][~k.numpy()],
                                      tokens[sl][~k.numpy()])
    if case == "ample":  # the dense oracle
        choice = logits.argmax(1)
        gate = np.exp(logits - logits.max(1, keepdims=True))
        gate /= gate.sum(1, keepdims=True)
        g = gate[np.arange(len(tokens)), choice][:, None]
        expect = g * np.einsum("td,tde->te", tokens, w[choice]) \
            + (1 - g) * tokens
        np.testing.assert_allclose(got, expect, rtol=RTOL, atol=ATOL)


def test_moe_overflow_passthrough():
    n, t_local, d = 8, 8, 4
    rng = np.random.RandomState(2)
    tokens = rng.randn(n * t_local, d).astype("float32")
    logits = np.zeros((n * t_local, n), "float32")
    logits[:, 0] = 10.0
    out = _port_moe(np.zeros((n, d, d), "float32"), logits, tokens, 1)
    tok = tokens.reshape(n, t_local, d)
    res = out.reshape(n, t_local, d)
    np.testing.assert_array_equal(res[:, 1:], tok[:, 1:])
    g = 1.0 / (1.0 + (n - 1) * np.exp(-10.0))
    np.testing.assert_allclose(res[:, 0], (1 - g) * tok[:, 0], rtol=1e-4,
                               atol=1e-6)


def _dense_attention(q, k, v, causal=False):
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("thd,shd->hts", q, k) * scale
    if causal:
        t = q.shape[0]
        mask = np.arange(t)[:, None] >= np.arange(t)[None, :]
        s = np.where(mask[None], s, -np.inf)
    s = s - s.max(axis=2, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=2, keepdims=True)
    return np.einsum("hts,shd->thd", p, v)


@pytest.mark.mesh
@pytest.mark.parametrize("t,h,d,n,causal", [(32, 2, 4, 8, False),
                                            (24, 3, 5, 8, True),
                                            (32, 2, 8, 4, True),
                                            (8, 1, 4, 1, True)])
def test_ring_attention_matches_jax(t, h, d, n, causal):
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel.ring_attention import (
        make_seq_mesh as jmesh, ring_attention as jring)

    rng = np.random.RandomState(t + n)
    q, k, v = (rng.randn(t, h, d).astype("float32") for _ in range(3))
    want = np.asarray(jring(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jmesh(n, 8), axis="seq", causal=causal))
    mesh = make_seq_mesh(n, devices=_devs())
    got = ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), mesh, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _dense_attention(q, k, v, causal),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.mesh
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_bfloat16_matches_jax(causal):
    """bfloat16 operands, float32 products and recurrence, a bfloat16
    result: within one bfloat16 rounding of JAX's."""
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel.ring_attention import (
        make_seq_mesh as jmesh, ring_attention as jring)

    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(32, 2, 8).astype("float32") for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jring(jq, jk, jv, jmesh(4, 8),
                                        axis="seq", causal=causal
                                        ).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ring_attention(tq, tk, tv, make_seq_mesh(4, devices=_devs()),
                         causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
