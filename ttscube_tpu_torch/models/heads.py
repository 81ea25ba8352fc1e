"""The vocoder's output heads, counterpart of `ttscube_tpu/models/heads.py`: a
discretized mixture of logistics (MOL, 10 components), a Gaussian, a Beta, and 256-way
μ-law and linear softmaxes. Each has `loss(y_hat, y)`, `sample(y_hat, generator)`,
`sample_size`, `stats`, `encode` and `decode`; `get_output_head` picks one by name.

`sample` takes its draws ready made (`noise`: the uniforms, normals or Gumbel noise the
JAX head draws from its key, in the shapes given per head), or draws them from an
explicit `torch.Generator` on that generator's device. `draw_noise(lead, generator)`
draws the noise of many steps at once (leading shape `lead`, e.g. (T, B)), which the
WaveRNN sampler moves to the card in one copy and indexes per step; the Beta head's
draws depend on its parameters, so it draws per step (`draw_noise` gives None).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ttscube_tpu_torch.dsp.mulaw import mulaw_decode, mulaw_encode, raw_decode, raw_encode


def _uniform(shape, generator, low: float = 0.0, high: float = 1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


class MOLOutput:
    """Discretized mixture of logistics, 10 components → 30 parameters."""

    sample_size = 30
    stats = (6e-6, 0.15)

    def loss(self, y_hat, y, num_classes: int = 65536,
             log_scale_min: float = math.log(1e-14)):
        nr_mix = y_hat.shape[2] // 3
        y = y[:, :, None]
        logit_probs = y_hat[:, :, :nr_mix]
        means = y_hat[:, :, nr_mix: 2 * nr_mix]
        log_scales = torch.clamp(y_hat[:, :, 2 * nr_mix:], min=log_scale_min)

        centered = y - means
        inv_stdv = torch.exp(-log_scales)
        plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
        min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
        cdf_plus = torch.sigmoid(plus_in)
        cdf_min = torch.sigmoid(min_in)
        log_cdf_plus = plus_in - F.softplus(plus_in)       # log σ(plus_in)
        log_one_minus_cdf_min = -F.softplus(min_in)        # log(1 − σ(min_in))
        cdf_delta = cdf_plus - cdf_min
        mid_in = inv_stdv * centered
        log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

        inner_inner = torch.where(cdf_delta > 1e-5,
                                  torch.log(torch.clamp(cdf_delta, min=1e-12)),
                                  log_pdf_mid - math.log((num_classes - 1) / 2))
        inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
        log_probs = torch.where(y < -0.999, log_cdf_plus, inner)
        log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
        return -torch.mean(torch.logsumexp(log_probs, dim=-1))

    def sample(self, y_hat, generator=None, noise=None,
               log_scale_min: float = math.log(1e-14), temperature: float = 1.0):
        """`noise`: (u1 of the logit probabilities' shape, u2 of the means' shape), both
        uniform in [1e-5, 1 − 1e-5) as JAX draws them from its key's two halves."""
        nr_mix = y_hat.shape[-1] // 3
        logit_probs = y_hat[..., :nr_mix]
        if noise is None:
            noise = [t.to(y_hat.device) for t in self.draw_noise(logit_probs.shape[:-1],
                                                                 generator)]
        u, u2 = noise
        # Gumbel-max over the mixture indicator; the temperature multiplies the uniform
        argmax = torch.argmax(logit_probs - torch.log(-torch.log(u * temperature)), dim=-1)
        one_hot = F.one_hot(argmax, nr_mix).to(y_hat.dtype)
        means = torch.sum(y_hat[..., nr_mix: 2 * nr_mix] * one_hot, dim=-1)
        log_scales = torch.clamp(torch.sum(y_hat[..., 2 * nr_mix:] * one_hot, dim=-1),
                                 min=log_scale_min)
        x = means + torch.exp(log_scales) * (torch.log(u2) - torch.log(1.0 - u2))
        return torch.clamp(x, -1.0, 1.0)

    def draw_noise(self, lead: tuple, generator):
        return (_uniform((*lead, self.sample_size // 3), generator, 1e-5, 1 - 1e-5),
                _uniform(lead, generator, 1e-5, 1.0 - 1e-5))

    def encode(self, x):
        return x

    def decode(self, x):
        return x


class GaussianOutput:
    sample_size = 2
    stats = (6e-6, 0.15)

    def loss(self, y_hat, y, log_std_min: float = -14.0):
        y = y[:, :, None]
        mean = y_hat[:, :, :1]
        log_std = torch.clamp(y_hat[:, :, 1:], min=log_std_min)
        nll = 0.5 * math.log(2.0 * math.pi) + log_std + \
            0.5 * (y - mean) ** 2 * torch.exp(-2.0 * log_std)
        return torch.mean(nll)

    def sample(self, y_hat, generator=None, noise=None, temperature: float = 0.8):
        """`noise`: standard normals of y_hat[..., :1]'s shape."""
        z = noise if noise is not None else self.draw_noise(y_hat.shape[:-1], generator).to(
            y_hat.device)
        return (y_hat[..., :1] + z * temperature * torch.exp(y_hat[..., 1:]))[..., 0]

    def draw_noise(self, lead: tuple, generator):
        return torch.randn((*lead, 1), generator=generator, device=generator.device)

    def encode(self, x):
        return x

    def decode(self, x):
        return x


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws from `generator`: Marsaglia and Tsang's squeeze method on
    alpha + 1 where alpha < 1, times U^(1/alpha) (JAX draws its own way: the tests hold
    the Beta head's draws to JAX's by their moments)."""
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=generator, device=a.device)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(
            torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


class BetaOutput:
    sample_size = 2
    stats = (6e-6, 0.15)

    def loss(self, y_hat, y):
        loc = torch.exp(y_hat)
        alpha = loc[:, :, 0]
        beta = loc[:, :, 1]
        y = torch.clamp((y + 1.0) / 2.0, 1e-5, 0.99999)
        logp = (alpha - 1) * torch.log(y) + (beta - 1) * torch.log1p(-y) - \
            (torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta))
        return -torch.mean(logp)

    def sample(self, y_hat, generator=None, noise=None):
        """`noise`: Beta(α, β) draws in [0, 1] of α's shape."""
        loc = torch.exp(y_hat)
        if noise is None:
            loc_g = loc.to(generator.device)
            ga, gb = _gamma(loc_g[..., 0], generator), _gamma(loc_g[..., 1], generator)
            noise = (ga / (ga + gb)).to(y_hat.device)
        return (noise - 0.5) * 2.0

    def draw_noise(self, lead: tuple, generator):
        return None

    def encode(self, x):
        return x

    def decode(self, x):
        return x


class _Softmax256:
    """A 256-way softmax over codes of a codec (`_encode`, `_decode`)."""

    sample_size = 256

    def loss(self, y_hat, y):
        codes = self.encode(y).to(y_hat.device)
        logp = torch.log_softmax(y_hat, dim=-1)
        return torch.mean(-torch.gather(logp, -1, codes[..., None])[..., 0])

    def sample(self, y_hat, generator=None, noise=None):
        """A categorical draw by the Gumbel-max trick; `noise`: Gumbel draws of y_hat's
        shape (JAX's `random.categorical` adds `random.gumbel(key, shape)`)."""
        if noise is None:
            noise = self.draw_noise(y_hat.shape[:-1], generator).to(y_hat.device)
        return self.decode(torch.argmax(y_hat + noise, dim=-1))

    def draw_noise(self, lead: tuple, generator):
        u = torch.rand((*lead, self.sample_size), generator=generator,
                       device=generator.device)
        return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


class MULAWOutput(_Softmax256):
    stats = (-0.019, 0.51)

    def encode(self, x):
        return mulaw_encode(x)

    def decode(self, x):
        return mulaw_decode(x).to(x.device)


class RAWOutput(_Softmax256):
    stats = (-0.019, 0.15)

    def encode(self, x):
        return raw_encode(x)

    def decode(self, x):
        return raw_decode(x).to(x.device)


def get_output_head(name: str):
    """A head by name: mol, gm, beta, mulaw or raw."""
    return {"mol": MOLOutput, "gm": GaussianOutput, "beta": BetaOutput,
            "mulaw": MULAWOutput, "raw": RAWOutput}[name]()
