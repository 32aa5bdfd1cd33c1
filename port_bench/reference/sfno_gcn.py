"""Plain fp32 reference of the GCN-filmed SFNO (FourCastNetv2-small SFNO,
Bonev et al. 2023, arXiv:2306.03838; MSFNO's `gcn_custom` FiLM generator),
its L2Sphere_noSine loss, the film-only gradient and Adam.

Written from the published description for the benchmark's correctness
check: plain torch operations on fp32 tensors, channels-last (B, H, W, C),
no kernel, cache or fused path.  It imports nothing of the program under
test.  The longitude transforms are `torch.fft.rfft` / `irfft` (the program
runs them as matrix products), the Legendre stage an einsum per order.

Every matrix product takes its operands through `self.q`, the identity
here; the control of the check (`fp8_operands`) puts a per-tensor-scaled
float8 round trip there instead, the precision below the configuration's
bf16.  Parameter names and shapes are the original MSFNO state_dict's, so
one weight dictionary loads into this module and the program alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------- sphere


def gauss_legendre(n: int):
    """Gauss-Legendre nodes (cos theta, north to south) and weights."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x[::-1].copy(), w[::-1].copy()


def clenshaw_curtis(n: int):
    """Clenshaw-Curtis nodes and weights on the equiangular grid with both
    poles, north to south."""
    m = n - 1
    theta = np.arange(n) * np.pi / m
    k = np.arange(1, m // 2 + 1)
    b = np.full(m // 2, 2.0)
    if m % 2 == 0:
        b[-1] = 1.0
    w = np.array([(2.0 / m) * (1.0 - np.sum(b / (4.0 * k ** 2 - 1.0) * np.cos(2.0 * k * t)))
                  for t in theta])
    w[0] *= 0.5
    w[-1] *= 0.5
    return np.cos(theta), w


def legendre(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal associated Legendre functions with the Condon-Shortley
    phase, (mmax, lmax, nlat) float64, zero where l < m."""
    n = max(lmax, mmax)
    p = np.zeros((mmax, n, x.size))
    s = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    pmm = np.full(x.size, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(mmax):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s * pmm
        if m < n:
            p[m, m] = pmm
        if m + 1 < n:
            p[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, n):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            c = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            p[m, l] = a * (x * p[m, l - 1] - c * p[m, l - 2])
    return p[:, :lmax]


class SHT:
    """Real spherical harmonic transform pair on one grid, truncated to
    (lmax, mmax); spectra are (re, im) pairs of (B, L, M, C).  `rescale`
    multiplies the analysis and divides the synthesis (the reference
    model's 1e5 conditioning: round trips are unchanged)."""

    def __init__(self, nlat, nlon, lmax, mmax, grid, device, rescale=1e5):
        x, w = (clenshaw_curtis if grid == "equiangular" else gauss_legendre)(nlat)
        p = legendre(lmax, mmax, x)
        self.nlon, self.mmax = nlon, mmax
        self.ana = torch.tensor(2.0 * np.pi * p * w * rescale, dtype=torch.float32,
                                device=device)  # (M, L, H)
        self.syn = torch.tensor(p / rescale, dtype=torch.float32, device=device)

    def forward(self, x, q):
        f = torch.fft.rfft(q(x), dim=2, norm="forward")[:, :, :self.mmax]
        a = q(self.ana)
        return (torch.einsum("mlh,bhmc->blmc", a, q(f.real)),
                torch.einsum("mlh,bhmc->blmc", a, q(f.imag)))

    def inverse(self, re, im, q):
        s = q(self.syn)
        hr = torch.einsum("mlh,blmc->bhmc", s, q(re))
        hi = torch.einsum("mlh,blmc->bhmc", s, q(im))
        nfreq = self.nlon // 2 + 1
        pad = (0, 0, 0, nfreq - self.mmax)
        z = torch.complex(F.pad(hr, pad), F.pad(hi, pad))
        return torch.fft.irfft(z, n=self.nlon, dim=2, norm="forward")


# ---------------------------------------------------------------- layers


def identity(t):
    return t


def _fp8_round(t, dtype, top):
    """A per-tensor-scaled float8 round trip: the tensor's largest magnitude
    maps to the format's largest finite value."""
    s = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t.detach() / s).to(dtype).float() * s


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand on e4m3; backward: its gradient on e5m2 (the
    usual float8 training formats)."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def fp8_operands(t):
    """A matrix operand computed in float8: the control of the check, the
    precision below the configuration's bf16."""
    return _Fp8Operand.apply(t)


class Conv1x1(nn.Module):
    def __init__(self, c_in, c_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, 1, 1))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def apply(self, x, q):
        y = q(x) @ q(self.weight[:, :, 0, 0]).t()
        return y if self.bias is None else y + self.bias


class Mlp(nn.Module):
    def __init__(self, c_in, hidden, c_out, out_bias=True):
        super().__init__()
        self.fwd = nn.ModuleDict({"0": Conv1x1(c_in, hidden),
                                  "2": Conv1x1(hidden, c_out, out_bias)})

    def apply(self, x, q):
        return self.fwd["2"].apply(F.gelu(self.fwd["0"].apply(x, q)), q)


class InstanceNorm(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.eps = eps

    def apply(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def complex_linear(re, im, w, q):
    """(re + i im) @ (w[..., 0] + i w[..., 1]) over the channel axis."""
    wr, wi = q(w[..., 0]), q(w[..., 1])
    re, im = q(re), q(im)
    return re @ wr - im @ wi, re @ wi + im @ wr


class SpectralFilter(nn.Module):
    """The non-linear spectral filter: a complex MLP over the retained modes
    (`spectral_layers` layers, ReLU on the real part), then `wout`."""

    def __init__(self, embed, hidden, layers):
        super().__init__()
        dims = [embed] + [hidden] * layers
        self.w = nn.ParameterList([nn.Parameter(torch.empty(dims[i], dims[i + 1], 2))
                                   for i in range(layers)])
        self.wout = nn.Parameter(torch.empty(hidden, embed, 2))

    def apply(self, re, im, q):
        for w in self.w:
            re, im = complex_linear(re, im, w, q)
            re = F.relu(re)
        return complex_linear(re, im, self.wout, q)


class Block(nn.Module):
    def __init__(self, embed, hidden, layers, inner, mlp):
        super().__init__()
        self.norm0 = InstanceNorm(embed)
        self.filter_layer = nn.Module()
        self.filter_layer.filter = SpectralFilter(embed, hidden, layers)
        self.inner_skip = Conv1x1(embed, embed) if inner else None
        self.norm1 = InstanceNorm(embed)
        self.mlp = Mlp(embed, hidden, embed) if mlp else None

    def apply(self, x, fwd, inv, film, q):
        residual = x
        re, im = fwd.forward(self.norm0.apply(x), q)
        re, im = self.filter_layer.filter.apply(re, im, q)
        y = inv.inverse(re, im, q)
        if self.inner_skip is not None:
            y = y + self.inner_skip.apply(residual, q)
        y = self.norm1.apply(y)
        if film is not None:
            gamma, beta, scale = film
            y = (1.0 + gamma[:, None, None, :] * scale) * y + beta[:, None, None, :] * scale
        if self.mlp is not None:
            y = self.mlp.apply(y, q)
        if self.inner_skip is not None:
            y = y + residual
        return y


# ------------------------------------------------------------ generator


def box3(v):
    """Self plus 8 neighbours of (B, H, W, F): periodic in longitude, zero
    past the poles."""
    zero = torch.zeros_like(v[:, :1])
    rows = v + torch.cat([zero, v[:, :-1]], 1) + torch.cat([v[:, 1:], zero], 1)
    return rows + torch.roll(rows, 1, 2) + torch.roll(rows, -1, 2)


class GraphConv(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out))
        self.bias = nn.Parameter(torch.empty(c_out))

    def apply(self, x, mask, dinv, q):
        support = q(x) @ q(self.weight)
        return (box3(support * dinv) * dinv + self.bias) * mask


class GCNFilm(nn.Module):
    """MSFNO's gcn_custom generator: the last SST day as the one node
    feature of the ocean grid graph (8 neighbours and a self loop, symmetric
    degree normalisation), conv1 then `depth` residual layers with leaky
    ReLU 0.01, the ocean mean, a linear head to (gamma, beta)."""

    def __init__(self, width, depth, out):
        super().__init__()
        self.depth = depth
        self.conv1 = GraphConv(1, width)
        for i in range(depth):
            self.add_module(f"conv_{i}", GraphConv(width, width))
        self.head_film = nn.Linear(width, out)

    def apply(self, sst, q):
        last = sst[:, -1]
        mask = (~torch.isnan(last))[..., None].float()
        x = torch.nan_to_num(last)[..., None] * mask
        deg = box3(mask) - mask + 1.0
        dinv = torch.where(mask > 0, torch.rsqrt(deg), torch.zeros_like(deg))
        x = F.leaky_relu(self.conv1.apply(x, mask, dinv, q), 0.01)
        for i in range(self.depth):
            x = x + F.leaky_relu(getattr(self, f"conv_{i}").apply(x, mask, dinv, q), 0.01)
        pooled = (x * mask).sum((1, 2)) / mask.sum((1, 2)).clamp(min=1.0)
        return q(pooled) @ q(self.head_film.weight).t() + self.head_film.bias


# ------------------------------------------------------------------ net


class FilmedSFNO(nn.Module):
    """encoder MLP + pos_embed -> `num_layers` SFNO blocks (the resolution
    drops `scale_factor`-fold in block 0 and returns in the last; blocks
    1..N-2 with a linear inner skip and an identity outer skip; no channel
    MLP in the last) -> the big-skip decoder over [features | input].  The
    generator's (gamma, beta) film the last block after its norm1."""

    def __init__(self, cfg: dict, device=None):
        super().__init__()
        self.cfg = cfg
        c, e = cfg["in_chans"], cfg["embed_dim"]
        hidden = int(cfg["mlp_ratio"] * e)
        n = cfg["num_layers"]
        self.encoder = Mlp(c, e, e, out_bias=False)
        h, w = cfg["img_size"]
        self.pos_embed = nn.Parameter(torch.empty(1, e, h, w))
        self.blocks = nn.ModuleList([
            Block(e, hidden, cfg["spectral_layers"], 0 < i < n - 1, i < n - 1)
            for i in range(n)])
        self.decoder = Mlp(e + c, e, cfg["out_chans"], out_bias=False)
        film = cfg["film"]
        self.film_gen = nn.Module()
        self.film_gen.film_gen = GCNFilm(film["embed_dim"], film["model_depth"], 2 * e)
        self.to(device)
        self.sht = None
        self.q = identity

    def transforms(self, device):
        """The full grid's equiangular pair and the inner Gauss grid's, made
        at the first forward on `device`."""
        if self.sht is None:
            cfg = self.cfg
            h, w = cfg["img_size"]
            hs, ws = h // cfg["scale_factor"], w // cfg["scale_factor"]
            lmax, mmax = hs, ws // 2 + 1
            full = SHT(h, w, lmax, mmax, "equiangular", device)
            self.sht = {"down": full, "up": full,
                        "in": SHT(hs, ws, lmax, mmax, "legendre-gauss", device)}
        return self.sht

    def film(self, sst):
        g = self.film_gen.film_gen.apply(sst, self.q)
        e = self.cfg["embed_dim"]
        return g[:, :e], g[:, e:]

    def forward(self, x, sst, scale=1.0):
        q, n = self.q, self.cfg["num_layers"]
        sht = self.transforms(x.device)
        gamma, beta = self.film(sst)
        residual = x
        y = self.encoder.apply(x, q) + self.pos_embed[0].permute(1, 2, 0)
        for i, blk in enumerate(self.blocks):
            fwd = sht["down"] if i == 0 else sht["in"]
            inv = sht["up"] if i == n - 1 else sht["in"]
            y = blk.apply(y, fwd, inv, (gamma, beta, scale) if i == n - 1 else None, q)
        return self.decoder.apply(torch.cat([y, residual], -1), q)


def parameter_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, in state_dict order; kind
    names the initialisation family the benchmark's weight maker draws
    from: "w<fan_in>" a product weight, "bias", "norm_w", "norm_b",
    "pos", "spectral", "head"."""
    net = FilmedSFNO(cfg, device="meta")
    specs = []
    for name, p in net.named_parameters():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "pos_embed":
            kind = "pos"
        elif "head_film" in name:
            kind = "head_w" if leaf == "weight" else "head_b"
        elif ".norm" in name:
            kind = "norm_w" if leaf == "weight" else "norm_b"
        elif ".filter." in name:
            kind = f"spectral{shape[0]}"
        elif leaf == "bias":
            kind = "bias"
        else:
            fan_in = shape[1] if p.dim() == 4 else shape[0]
            kind = f"w{fan_in}"
        specs.append((name, shape, kind))
    return specs


# --------------------------------------------------------- loss, training


def l2_sphere_nosine(prd, tar):
    """Relative squared L2 on the grid with Gauss-Legendre row weights,
    summed over samples and channels."""
    _, w = gauss_legendre(prd.shape[1])
    w = torch.tensor(w, dtype=torch.float32, device=prd.device)[:, None, None]
    num = (w * (prd - tar) ** 2).sum((1, 2))
    den = (w * tar ** 2).sum((1, 2))
    return (num / den).sum()


def rollout_loss(net, era5, sst, ms, scale=1.0):
    """The multi-step loss: ms + 1 chained steps from era5[0], each scored
    against the next state and divided by ms + 1.  Returns (loss, [per-step
    losses])."""
    inp, total, parts = era5[0], 0.0, []
    for s in range(ms + 1):
        out = net(inp, sst[s + 1], scale)
        part = l2_sphere_nosine(out, era5[s + 1]) / (ms + 1)
        total = total + part
        parts.append(part.detach())
        inp = out
    return total, parts


class Adam:
    """Adam with optax's formulas: b1 0.9, b2 0.999, eps 1e-8."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for n, p in params.items():
            g = grads[n]
            self.mu[n].mul_(0.9).add_(0.1 * g)
            self.nu[n].mul_(0.999).add_(0.001 * g * g)
            p.sub_(self.lr * (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + 1e-8))


def film_params(net: FilmedSFNO) -> dict:
    return {n: p for n, p in net.named_parameters() if n.startswith("film_gen.")}


def train(net: FilmedSFNO, batches, ms: int, lr: float, scale=1.0):
    """Film-only Adam steps over `batches` of (era5 (S, B, H, W, C), sst (S,
    B, T, Hs, Ws)).  Returns the per-step losses, the first step's
    gradients and the trainable parameters after the last step."""
    params = film_params(net)
    for n, p in net.named_parameters():
        p.requires_grad_(n in params)
    opt, losses, first = Adam(params, lr), [], None
    for era5, sst in batches:
        loss, _ = rollout_loss(net, era5, sst, ms, scale)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
        del loss, grads
    return losses, first, {n: p.detach().clone() for n, p in params.items()}

