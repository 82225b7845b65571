"""The port's ring attention against the JAX package's, on the CPU.

Copies of tests/test_ring_attention.py's four tests with the port's
in-process form at p = 8 (the JAX tests' 8-device CPU mesh) and the same
tolerances (outputs rtol/atol 2e-4, gradients 1e-3); the port against
JAX's `ring_attention` on that mesh on the same numpy inputs (outputs
2e-4, gradients 1e-3); and the form across processes (two gloo
processes through tests/torch_ring_runner.py) against `full_attention`
(2e-4 and 1e-3) and against the in-process form at p = 2 (1e-6).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from adanet_tpu.parallel import full_attention as jax_full_attention
from adanet_tpu.parallel import ring_attention as jax_ring_attention

from adanet_tpu_torch.parallel import SequenceMesh, full_attention, ring_attention
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

HERE = os.path.dirname(os.path.abspath(__file__))


def _qkv(batch=2, seq=32, heads=4, dim=8, seed=0, requires_grad=False):
    rng = np.random.RandomState(seed)
    shape = (batch, seq, heads, dim)
    return tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32, requires_grad=requires_grad)
                 for _ in range(3))


def _mesh():
    return SequenceMesh(8)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full_attention(causal):
    q, k, v = _qkv()
    out_ring = ring_attention(q, k, v, _mesh(), causal=causal)
    out_full = full_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out_ring, out_full, rtol=2e-4, atol=2e-4)


def test_ring_attention_longer_sequence_causal():
    """The JAX test's sharded-input and jit case: seq 64, causal; the
    output keeps the input's shape (the port has no sharding type)."""
    q, k, v = _qkv(seq=64)
    out = ring_attention(q, k, v, _mesh(), causal=True)
    np.testing.assert_allclose(out, full_attention(q, k, v, causal=True), rtol=2e-4, atol=2e-4)
    assert out.shape == q.shape and out.dtype == q.dtype


def test_ring_attention_gradients_match():
    q, k, v = _qkv(seq=16, requires_grad=True)
    g_ring = torch.autograd.grad((ring_attention(q, k, v, _mesh(), causal=True) ** 2).sum(), (q, k, v))
    g_full = torch.autograd.grad((full_attention(q, k, v, causal=True) ** 2).sum(), (q, k, v))
    for a, b in zip(g_ring, g_full):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_indivisible_sequence_raises():
    q, k, v = _qkv(seq=30)  # not divisible by 8
    with pytest.raises(ValueError):
        ring_attention(q, k, v, _mesh())


@pytest.mark.parametrize("causal", [False, True])
def test_port_matches_jax_ring_on_the_8_device_mesh(causal):
    q, k, v = _qkv(seq=32, requires_grad=True)
    mesh = Mesh(np.asarray(jax.devices()), axis_names=("sp",))
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))
    want = jax_ring_attention(jq, jk, jv, mesh, causal=causal)
    got = ring_attention(q, k, v, _mesh(), causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    g_want = jax.grad(lambda a, b, c: jnp.sum(jax_ring_attention(a, b, c, mesh, causal=causal) ** 2),
                      argnums=(0, 1, 2))(jq, jk, jv)
    g_got = torch.autograd.grad((got ** 2).sum(), (q, k, v))
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)
    # And JAX's full attention, the oracle both packages hold the ring to.
    np.testing.assert_allclose(full_attention(q, k, v, causal=causal).detach().numpy(),
                               np.asarray(jax_full_attention(jq, jk, jv, causal=causal)), rtol=2e-4, atol=2e-4)


def test_bfloat16_ring_matches_full_attention():
    """bf16 inputs: f32 scores and sums inside, the output in bf16; the
    ring and full attention agree to bf16's rounding of the output."""
    q, k, v = (t.to(torch.bfloat16) for t in _qkv())
    out = ring_attention(q, k, v, _mesh(), causal=True)
    assert out.dtype == torch.bfloat16
    want = full_attention(q, k, v, causal=True).float()
    np.testing.assert_allclose(out.float(), want, rtol=0, atol=float(want.abs().max()) * 2 ** -8)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_ring_across_two_processes(tmp_path):
    """Form (b): two gloo processes, one shard each; rank 0's output and
    gradients against full attention and against form (a) at p = 2."""
    port = _free_port()
    script = os.path.join(HERE, "torch_ring_runner.py")
    procs = [subprocess.Popen([sys.executable, script, str(tmp_path), str(rank), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1")) for rank in (0, 1)]
    for proc in procs:
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
    got = np.load(str(tmp_path / "ring.npz"))
    stats = json.load(open(str(tmp_path / "ring.json")))
    # Forward: 1 hop of k/v; backward: 1 hop of k/v and accumulators and
    # 1 home; CPU tensors stage nothing.
    assert stats["hops"] == 3 and stats["staged_bytes"] == 0
    q, k, v = _qkv(requires_grad=True)
    for mesh, atol_out, atol_grad in ((None, 2e-4, 1e-3), (SequenceMesh(2), 1e-6, 1e-6)):
        out = full_attention(q, k, v, causal=True) if mesh is None else ring_attention(q, k, v, mesh, causal=True)
        grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        np.testing.assert_allclose(got["out"], out.detach().numpy(), rtol=atol_out, atol=atol_out)
        for name, grad in zip("qkv", grads):
            np.testing.assert_allclose(got["d" + name], grad.numpy(), rtol=atol_grad, atol=atol_grad)
