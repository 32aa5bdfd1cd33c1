"""The port's latitude-sharded SHT (`msfno_torch.parallel.sharded_sht`)
against the JAX package's, shard by shard.

The port's ranks run as gloo processes (this file is their worker,
`python tests/test_torch_sharded_sht.py RANK WORLD PORT DIR`), one spawn
of P ranks for each P, each rank computing every case into one `.npz`;
the JAX transforms run in this process on the simulated CPU devices.  No
process group is ever created in the pytest process.
"""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NLON, LMAX, B, C = 40, 10, 2, 3
NLATS = (16, 21)  # 21: the rows do not divide by P (tests/test_sharded_sht.py:177)
LAYOUTS = [(inter, lb) for inter in (True, False) for lb in (1, 2, 4)]
PS = (2, 4)


def _inputs(nlat: int):
    rng = np.random.default_rng(nlat)
    x = rng.standard_normal((B, nlat, NLON, C)).astype(np.float32)
    cot = rng.standard_normal((2, B, LMAX, 16, C)).astype(np.float32)  # m_pad <= 16
    return x, cot


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ the worker


def _worker(rank: int, world: int, port: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from msfno_torch.ops.sht import InverseRealSHT, RealSHT
    from msfno_torch.parallel.mesh import make_mesh
    from msfno_torch.parallel.sharded_sht import make_sharded_transforms

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_mesh(shape=(1, world, 1))
    out = {}
    for nlat in NLATS:
        x, cot = _inputs(nlat)
        kw = dict(lmax=LMAX, mmax=LMAX + 1, grid="equiangular")
        sht, isht = RealSHT(nlat, NLON, **kw), InverseRealSHT(nlat, NLON, **kw)
        for inter, lb in LAYOUTS:
            fwd, inv = make_sharded_transforms(sht, isht, mesh, interleaved=inter, l_blocks=lb)
            h0 = rank * fwd.hb
            band = np.zeros((B, fwd.hb, NLON, C), np.float32)
            real = x[:, h0:h0 + fwd.hb]
            band[:, :real.shape[1]] = real
            xb = torch.tensor(band, requires_grad=True)
            z = fwd(xb)
            tag = f"{nlat}_{int(inter)}_{lb}"
            out[f"fwd_{tag}"] = z.detach().numpy()
            out[f"canon_{tag}"] = fwd.to_canonical(z).detach().numpy()
            out[f"rt_{tag}"] = inv(z).detach().numpy()
            cot_k = torch.tensor(cot[..., rank * fwd.q:(rank + 1) * fwd.q, :])
            (g,) = torch.autograd.grad((z * cot_k).sum(), xb)
            out[f"grad_{tag}"] = g.numpy()
        bf, _ = make_sharded_transforms(sht, isht, mesh, comm_dtype="bfloat16")
        h0 = rank * bf.hb
        band = np.zeros((B, bf.hb, NLON, C), np.float32)
        band[:, :x[:, h0:h0 + bf.hb].shape[1]] = x[:, h0:h0 + bf.hb]
        out[f"bf16_{nlat}"] = bf(torch.tensor(band)).numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# --------------------------------------------------------------- the tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _port_run(p: int, out_dir: str) -> list[dict]:
    """Every rank's results of one spawn of p ranks."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(p), port,
                               out_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(p)]
    try:
        for pr in procs:
            out, err = pr.communicate(timeout=240)
            assert pr.returncode == 0, f"{pr.args} failed:\n{out}\n{err[-4000:]}"
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(p)]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_sht")

    def run(p: int) -> list[dict]:
        d = root / f"p{p}"
        d.mkdir(exist_ok=True)
        return _port_run(p, str(d))

    return run


def _jax_transforms(nlat, p, **kw):
    import jax
    from jax.sharding import Mesh

    from msfno_tpu.ops.sht import InverseRealSHT, RealSHT
    from msfno_tpu.parallel.sharded_sht import make_sharded_transforms

    mesh = Mesh(np.asarray(jax.devices()[:p]), ("lat",))
    sk = dict(lmax=LMAX, mmax=LMAX + 1, grid="equiangular")
    return make_sharded_transforms(RealSHT(nlat, NLON, **sk), InverseRealSHT(nlat, NLON, **sk),
                                   mesh, "lat", **kw)


def _pair(z):
    """JAX complex (B, L, M, C) -> the port's (2, B, L, M, C)."""
    return np.stack([np.real(z), np.imag(z)])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_mode_layout_matches_jax(p):
    from msfno_torch.parallel import sharded_sht as port
    from msfno_tpu.parallel import sharded_sht as ref

    for m_pad in (p * 2, p * 3, p * 46):
        np.testing.assert_array_equal(port.interleave_perm(m_pad, p),
                                      ref.interleave_perm(m_pad, p))
        for lmax in (10, 360):
            for inter in (True, False):
                for lb in (1, 2, 4):
                    a = port._mode_layout(p, m_pad, lmax, inter, lb)
                    b = ref._mode_layout(p, m_pad, lmax, inter, lb)
                    assert a[:2] == b[:2] and a[4:] == b[4:]
                    np.testing.assert_array_equal(a[2], b[2])
                    np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("nlat", NLATS)
@pytest.mark.parametrize("inter,lb", LAYOUTS)
def test_forward_shards_match_jax(port_run, p, nlat, inter, lb):
    """Each rank's m-shard of ShardedRealSHT (fp32) equals the matching
    slice of the JAX ShardedRealSHT's output, and its `to_canonical` the
    JAX one's."""
    import jax

    x, _ = _inputs(nlat)
    fwd, _ = _jax_transforms(nlat, p, interleaved=inter, l_blocks=lb)
    out = jax.jit(fwd)(x)
    want, canon = _pair(np.asarray(out)), _pair(np.asarray(fwd.to_canonical(out)))
    q = fwd.m_pad // p
    for r, res in enumerate(port_run(p)):
        got = res[f"fwd_{nlat}_{int(inter)}_{lb}"]
        err = rel_l2(got, want[..., r * q:(r + 1) * q, :])
        print(f"parity sharded_sht fwd P={p} nlat={nlat} interleaved={inter} l_blocks={lb} "
              f"rank {r} rel_l2={err:.3e}")
        assert err <= 1e-6
        # to_canonical: the dense (L, mmax) rectangle, gathered on every rank
        assert rel_l2(res[f"canon_{nlat}_{int(inter)}_{lb}"], canon) <= 1e-6


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("nlat", NLATS)
def test_round_trip_and_gradient_match_jax(port_run, p, nlat):
    """The sharded round trip's bands equal JAX's rows (the padded rows
    zero), and the gradient of sum(SHT(x) * cot) by each rank's band equals
    jax.grad's rows, for every layout."""
    import jax
    import jax.numpy as jnp

    x, cot = _inputs(nlat)
    for inter, lb in LAYOUTS:
        fwd, inv = _jax_transforms(nlat, p, interleaved=inter, l_blocks=lb)
        rt = np.asarray(jax.jit(lambda v: inv(fwd(v)))(x))
        c = jnp.asarray(cot[..., :fwd.m_pad, :])

        def scalar(v):
            z = fwd(v)
            return jnp.sum(jnp.real(z) * c[0] + jnp.imag(z) * c[1])

        g = np.asarray(jax.jit(jax.grad(scalar))(jnp.asarray(x)))
        hb = -(-nlat // p)
        for r, res in enumerate(port_run(p)):
            tag = f"{nlat}_{int(inter)}_{lb}"
            n = min(hb, nlat - r * hb)
            for name, want in (("rt", rt), ("grad", g)):
                got = res[f"{name}_{tag}"]
                err = rel_l2(got[:, :n], want[:, r * hb:r * hb + n])
                print(f"parity sharded_sht {name} P={p} nlat={nlat} {tag} rank {r} "
                      f"rel_l2={err:.3e}")
                assert err <= (1e-6 if name == "rt" else 1e-5)
                assert not np.any(got[:, n:])


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("nlat", NLATS)
def test_bf16_transport_matches_jax(port_run, p, nlat):
    """comm_dtype="bfloat16": the payload rounded to bf16 at the same point
    as the JAX transform's (JAX's own tolerance, 2e-2)."""
    import jax

    x, _ = _inputs(nlat)
    fwd, _ = _jax_transforms(nlat, p, comm_dtype="bfloat16")
    want = _pair(np.asarray(jax.jit(fwd)(x)))
    fp32 = _pair(np.asarray(jax.jit(_jax_transforms(nlat, p)[0])(x)))
    q = fwd.m_pad // p
    for r, res in enumerate(port_run(p)):
        got = res[f"bf16_{nlat}"]
        err = rel_l2(got, want[..., r * q:(r + 1) * q, :])
        print(f"parity sharded_sht bf16 transport P={p} nlat={nlat} rank {r} rel_l2={err:.3e}")
        assert err <= 2e-2
        assert rel_l2(got, fp32[..., r * q:(r + 1) * q, :]) > 1e-4  # the payload was rounded


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
