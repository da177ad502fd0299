"""Port parity: colour spaces, colour augmentation and background
replacement against the JAX package (``ops/color_space.py``,
``ops/color_aug.py``).

The JAX functions draw from keys inside their bodies; ``jax_*_draws`` below
replay their key schedules op for op (``split(key, 32)`` for cosy+aae,
``split(key, 20)`` for aae, 8 for ssd, 4 for roi10d, 2 for the background)
with the JAX package's own helpers, and the port's augmentation takes those
draws. Tolerances: every colour-space pair at 1e-5 (relative, and absolute near
0); every preset on the [0, 255] scale at 1e-3 absolute against the JAX
function run op by op (``jax.disable_jit``), and at 5e-3 against it
compiled (XLA fuses the 3x3 blur's sums, which EnhanceSharpness's factor of
up to 50 amplifies: up to 1.9e-3 from its own op-by-op result); ssd's uint8
output within one unit on < 0.1% of the values (the truncation of floats
that agree to 1e-3);
``replace_background`` and its gate exactly. The ``draw_*`` functions'
gates are held to their probabilities by a seeded count (a fixed seed: the
same count every run) within 5 binomial standard deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops import color_aug as jca
from gdrnpp_bop2022_tpu.ops import color_space as jcs
from gdrnpp_bop2022_torch.ops import color_aug as tca
from gdrnpp_bop2022_torch.ops import color_space as tcs

PIX = np.random.RandomState(7).rand(4, 9, 11, 3).astype(np.float32)

PAIRS = [("rgb_to_grayscale", None), ("bgr_to_grayscale", None), ("rgb_to_bgr", None),
         ("rgb_to_rgba", "rgba_to_rgb"), ("rgb_to_hsv", "hsv_to_rgb"),
         ("rgb_to_hls", "hls_to_rgb"), ("rgb_to_xyz", "xyz_to_rgb"),
         ("rgb_to_lab", "lab_to_rgb"), ("rgb_to_luv", "luv_to_rgb"),
         ("rgb_to_ycbcr", "ycbcr_to_rgb"), ("rgb_to_yuv", "yuv_to_rgb"),
         ("normalize_lab", "denormalize_lab")]


@pytest.mark.parametrize("fwd,inv", PAIRS)
def test_color_space_pairs_match_jax(fwd, inv):
    want = np.asarray(getattr(jcs, fwd)(jnp.asarray(PIX)))
    got = getattr(tcs, fwd)(torch.from_numpy(PIX)).numpy()
    # 1e-5 relative (Lab and Luv reach ~100, where one fp32 ulp is 7.6e-6)
    # with a 1e-5 absolute floor
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=fwd)
    if inv is not None:
        back_j = np.asarray(getattr(jcs, inv)(jnp.asarray(want)))
        back_t = getattr(tcs, inv)(torch.from_numpy(want.copy())).numpy()
        np.testing.assert_allclose(back_t, back_j, rtol=1e-5, atol=1e-5, err_msg=inv)


# -- the JAX key schedules, replayed ----------------------------------------------

def _flat(a):
    """(B, 1, 1, C) -> (B, C); (B, 1, 1, 1) gates -> (B,)."""
    a = np.asarray(a, np.float32)
    return a.reshape(a.shape[0], -1)


def _vec(a):
    return _flat(a)[:, 0]


def jax_cosy_draws(key, shape, global_prob):
    B, H, W, _ = shape
    keys = jax.random.split(key, 32)
    ki = iter(range(32))

    def nk():
        return keys[next(ki)]

    def gate(p):
        return _vec(jca._gate(nk(), p, B))

    def u(lo=0.0, hi=1.0):
        return _vec(jax.random.uniform(nk(), (B, 1, 1, 1), minval=lo, maxval=hi))

    def logu(lo, hi):
        return _vec(jnp.exp(jax.random.uniform(nk(), (B, 1, 1, 1), minval=jnp.log(lo),
                                               maxval=jnp.log(hi))))

    d = {"applied": _vec(jax.random.bernoulli(nk(), global_prob, (B, 1, 1, 1)))}
    d["drop_gate"] = gate(0.5)
    gh, gw = max(int(H * 0.05), 1), max(int(W * 0.05), 1)
    d["drop_mask"] = np.asarray(jax.random.bernoulli(nk(), 0.2, (B, gh, gw, 1)),
                                np.float32)[..., 0]
    d["blur_gate"] = gate(0.4)
    d["blur_strength"] = u()
    d["sharp_gate"] = gate(0.3)
    d["sharp_f"] = u(0.0, 50.0)
    d["contrast_gate"] = gate(0.3)
    d["contrast_f"] = logu(0.2, 5.0)
    d["bright_gate"] = gate(0.5)
    d["bright_f"] = logu(0.1, 6.0)
    d["color_gate"] = gate(0.3)
    d["color_f"] = logu(0.05, 20.0)
    d["add_gate"] = gate(0.5)
    d["add"] = _flat(jca._uniform(nk(), B, -25.0, 25.0, per_channel_key=nk(),
                                  per_channel_p=0.3))
    d["invert_gate"] = gate(0.3)
    d["invert"] = _flat(jax.random.bernoulli(nk(), 0.2, (B, 1, 1, 3)))
    d["mul_pc_gate"] = gate(0.5)
    d["mul_pc"] = _flat(jca._uniform(nk(), B, 0.6, 1.4, per_channel_key=nk(),
                                     per_channel_p=0.5))
    d["mul_gate"] = gate(0.5)
    d["mul"] = _flat(jca._uniform(nk(), B, 0.6, 1.4))
    d["noise_gate"] = gate(0.1)
    d["noise"] = np.asarray(10.0 * jax.random.normal(nk(), shape), np.float32)
    d["lc_gate"] = gate(0.5)
    d["lc"] = _flat(jca._uniform(nk(), B, 0.5, 2.2, per_channel_key=nk(), per_channel_p=0.3))
    d["gray_gate"] = gate(0.5)
    d["gray_alpha"] = u()
    return d


def jax_aae_draws(key, shape):
    B, H, W, _ = shape
    keys = jax.random.split(key, 20)
    ki = iter(range(20))

    def nk():
        return keys[next(ki)]

    def gate(p):
        return _vec(jca._gate(nk(), p, B))

    d = {"drop_gate": gate(0.5)}
    gh, gw = max(int(H * 0.05), 1), max(int(W * 0.05), 1)
    d["drop_mask"] = np.asarray(jax.random.bernoulli(nk(), 0.2, (B, gh, gw, 1)),
                                np.float32)[..., 0]
    d["blur_gate"] = gate(0.5)
    d["blur_strength"] = _vec(jax.random.uniform(nk(), (B, 1, 1, 1), maxval=1.2) / 1.2)
    d["add_gate"] = gate(0.5)
    d["add"] = _flat(jca._uniform(nk(), B, -25.0, 25.0, per_channel_key=nk(),
                                  per_channel_p=0.3))
    d["invert_gate"] = gate(0.3)
    d["invert"] = _flat(jax.random.bernoulli(nk(), 0.2, (B, 1, 1, 3)))
    d["mul_pc_gate"] = gate(0.5)
    d["mul_pc"] = _flat(jca._uniform(nk(), B, 0.6, 1.4, per_channel_key=nk(),
                                     per_channel_p=0.5))
    d["mul_gate"] = gate(0.5)
    d["mul"] = _flat(jca._uniform(nk(), B, 0.6, 1.4))
    d["lc_gate"] = gate(0.5)
    d["lc"] = _flat(jca._uniform(nk(), B, 0.5, 2.2, per_channel_key=nk(), per_channel_p=0.3))
    return d


def jax_ssd_draws(key, shape):
    B = shape[0]
    k = jax.random.split(key, 8)
    u = lambda kk, lo, hi: _vec(jax.random.uniform(kk, (B, 1, 1, 1), minval=lo,   # noqa: E731
                                                   maxval=hi))
    return {"brightness": u(k[0], -32.0, 32.0), "brightness_gate": _vec(jca._gate(k[1], 0.5, B)),
            "contrast": u(k[2], 0.5, 1.5), "contrast_gate": _vec(jca._gate(k[3], 0.5, B)),
            "saturation": u(k[4], 0.5, 1.5), "saturation_gate": _vec(jca._gate(k[5], 0.5, B)),
            "hue": _vec(jax.random.uniform(k[6], (B, 1, 1), minval=-18.0, maxval=18.0)),
            "hue_gate": _vec(jca._gate(k[7], 0.5, B))}


def jax_roi10d_draws(key, shape):
    B = shape[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = 2.5 / 255.0
    return {"brightness": _vec(jax.random.uniform(k1, (B, 1, 1, 1), minval=-d, maxval=d)),
            "lighting": np.asarray(jax.random.normal(k2, (B, 3)) * 0.3, np.float32),
            "saturation": _vec(jax.random.uniform(k3, (B, 1, 1, 1), minval=0.95, maxval=1.05)),
            "contrast": _vec(jax.random.uniform(k4, (B, 1, 1, 1), minval=0.95, maxval=1.05))}


JAX_DRAWS = {"cosy+aae": lambda k, s: jax_cosy_draws(k, s, 0.8), "aae": jax_aae_draws,
             "ssd": jax_ssd_draws, "roi10d": jax_roi10d_draws}
# the gates each preset's keys must fire at least once over SEEDS, so every op is held
GATES = {"cosy+aae": ("applied", "drop_gate", "blur_gate", "sharp_gate", "contrast_gate",
                      "bright_gate", "color_gate", "add_gate", "invert_gate", "mul_pc_gate",
                      "mul_gate", "noise_gate", "lc_gate", "gray_gate"),
         "aae": ("drop_gate", "blur_gate", "add_gate", "invert_gate", "mul_pc_gate",
                 "mul_gate", "lc_gate"),
         "ssd": ("brightness_gate", "contrast_gate", "saturation_gate", "hue_gate"),
         "roi10d": ()}
SEEDS = (0, 1, 4)           # together they fire every gate of every preset
SHAPE = (6, 24, 40, 3)


def _torch_draws(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("preset", ["cosy+aae", "aae", "ssd", "roi10d"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_presets_match_jax_given_its_draws(preset, dtype):
    # colour gradients and noise: the RGB covariance (roi10d's PCA lighting)
    # has distinct eigenvalues, so its eigenvectors are defined up to sign
    rs = np.random.RandomState(11)
    B, H, W, _ = SHAPE
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 200.0 / W, yy * 120.0 / H, 60.0 + 0.3 * xx], -1)
    imgs = np.clip(base[None] + rs.randint(0, 40, SHAPE), 0, 255).astype(dtype)
    if dtype == "float32":
        imgs = imgs + rs.rand(*SHAPE).astype(np.float32)
    jfn = jca.color_aug_by_type(preset)
    _, tfn = tca.color_aug_by_type(preset)
    fired = set()
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        want_jit = np.asarray(jfn(key, jnp.asarray(imgs)))
        with jax.disable_jit():
            want = np.asarray(jfn(key, jnp.asarray(imgs)))
        draws = JAX_DRAWS[preset](key, SHAPE)
        fired |= {g for g in GATES[preset] if draws[g].any()}
        got = tfn(torch.from_numpy(imgs), _torch_draws(draws)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == np.uint8:      # ssd returns the input dtype, truncated
            for w in (want, want_jit):
                d = np.abs(got.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, (preset, seed, d.max())
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                       err_msg=f"{preset} seed {seed}")
            np.testing.assert_allclose(got, want_jit, rtol=0, atol=5e-3,
                                       err_msg=f"{preset} seed {seed}, compiled")
    assert fired == set(GATES[preset]), set(GATES[preset]) - fired


def test_global_probability_blend_of_other_presets():
    """The trainer's blend for presets other than cosy+aae (JAX
    engine/trainer.py:254-260): a per-sample gate around the preset."""
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 256, SHAPE).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    k_g, k_a = jax.random.split(key)
    gate = jax.random.bernoulli(k_g, 0.8, (SHAPE[0], 1, 1, 1)).astype(jnp.float32)
    auged = jca.aae_color_aug(k_a, jnp.asarray(imgs))
    want = np.asarray(jnp.asarray(imgs).astype(jnp.float32) * (1 - gate) + auged * gate)
    draws = {"gate": torch.from_numpy(_vec(gate)), "aug": _torch_draws(jax_aae_draws(k_a, SHAPE))}
    got = tca.apply_color_aug(torch.from_numpy(imgs), draws, "aae").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert 0 < _vec(gate).sum() < SHAPE[0]


def test_replace_background_is_exact():
    rs = np.random.RandomState(4)
    B, H, W = 8, 12, 16
    imgs = rs.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    fg = (rs.rand(B, H, W) > 0.4).astype(np.float32)
    bgs = rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(9)
    want, want_gate = jca.replace_background(key, jnp.asarray(imgs), jnp.asarray(fg),
                                             jnp.asarray(bgs), prob=0.5, return_gate=True)
    k1, k2 = jax.random.split(key)
    draws = {"bg_idx": torch.from_numpy(np.asarray(jax.random.randint(k1, (B,), 0, B),
                                                   np.int64)),
             "use": torch.from_numpy(_vec(jax.random.bernoulli(k2, 0.5, (B, 1, 1, 1))))}
    got, gate = tca.replace_background(torch.from_numpy(imgs), torch.from_numpy(fg),
                                       torch.from_numpy(bgs), draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(want_gate))
    assert 0 < gate.sum() < B


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown color aug"):
        tca.color_aug_by_type("nope")


def _rate_ok(x, p, n):
    """A count's rate within 5 binomial standard deviations of p."""
    return abs(float(x) - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12


@pytest.mark.parametrize("preset", ["cosy+aae", "aae", "ssd"])
def test_draw_gate_rates(preset):
    B = 4000
    g = torch.Generator().manual_seed(1234)
    if preset == "cosy+aae":
        d = tca.draw_cosy_aae(g, (B, 4, 4, 3), global_prob=0.8)
        probs = {"applied": 0.8, "drop_gate": 0.5, "blur_gate": 0.4, "sharp_gate": 0.3,
                 "contrast_gate": 0.3, "bright_gate": 0.5, "color_gate": 0.3,
                 "add_gate": 0.5, "invert_gate": 0.3, "mul_pc_gate": 0.5, "mul_gate": 0.5,
                 "noise_gate": 0.1, "lc_gate": 0.5, "gray_gate": 0.5}
    elif preset == "aae":
        d = tca.draw_aae(g, (B, 4, 4, 3))
        probs = {"drop_gate": 0.5, "blur_gate": 0.5, "add_gate": 0.5, "invert_gate": 0.3,
                 "mul_pc_gate": 0.5, "mul_gate": 0.5, "lc_gate": 0.5}
    else:
        d = tca.draw_ssd(g, (B, 4, 4, 3))
        probs = {k: 0.5 for k in ("brightness_gate", "contrast_gate", "saturation_gate",
                                  "hue_gate")}
    for k, p in probs.items():
        assert _rate_ok(d[k].mean(), p, B), (k, float(d[k].mean()), p)
    if preset != "ssd":
        assert _rate_ok(d["drop_mask"].mean(), 0.2, d["drop_mask"].numel())
        assert _rate_ok(d["invert"].mean(), 0.2, d["invert"].numel())
        # the per-channel coin of Add (p = 0.3): the three channels differ
        pc = (d["add"][:, 0] != d["add"][:, 1]).float().mean()
        assert _rate_ok(pc, 0.3, B), float(pc)
    bg = tca.draw_replace_background(g, B, 7, prob=0.5)
    assert _rate_ok(bg["use"].mean(), 0.5, B)
    assert int(bg["bg_idx"].min()) == 0 and int(bg["bg_idx"].max()) == 6
    c = tca.draw_color_aug(g, (B, 4, 4, 3), "ssd", prob=0.8)
    assert _rate_ok(c["gate"].mean(), 0.8, B)
