"""The DISN image branch's modules against the JAX package's: the resize in
its three regimes, the camera projection, the bilinear sampler (values and
both gradients), the encoder and the decoder at the tiny width of
tests/test_disn.py (forward and gradients), the offline VGG-16 loader, and
the image renderer and make_example(with_image=True) array for array."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deftet_tpu.data import image_render as jax_render
from deftet_tpu.data import pipeline as jax_pipeline
from deftet_tpu.data.shapes import random_shape
from deftet_tpu.nn import disn as jax_disn
from deftet_tpu.nn import disn_port as jax_port
from deftet_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from deftet_tpu_torch.data import image_render, pipeline
from deftet_tpu_torch.nn import disn, disn_port

TINY = dict(width=0.05, image_encoding_dim=64, image_size=32,
            local_feature_size=16)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.mark.parametrize("src,dst", [
    (32, 16), (100, 64), (16, 8),   # downsampling: antialiased
    (2, 7), (4, 64), (1, 7),        # upsampling
    (16, 16),                       # identity
])
def test_resize_matches_jax_image_resize(src, dst):
    """jax.image.resize(..., "linear") on NHWC against the port's
    antialiased bilinear on NCHW, within 1e-6 (values in [-1, 1]);
    without antialias a downsample differs by up to 2.4."""
    x = np.random.default_rng(src * 100 + dst).uniform(
        -1, 1, (2, src, src, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 5),
                                      method="linear"))
    got = disn.resize_linear(torch.tensor(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-6)
    if src == dst:
        assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), x)


def test_project_points_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (2, 300, 3)).astype(np.float32)
    cams = np.stack([jax_render.random_camera(rng) for _ in range(2)])
    ref = np.asarray(jax_disn.project_points(jnp.asarray(pts),
                                             jnp.asarray(cams)))
    got = disn.project_points(torch.tensor(pts), torch.tensor(cams)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (np.abs(got) <= 1).all(-1).mean() > 0.9  # mostly in frame


def test_bilinear_sample_values_and_gradients():
    """Values, the map's gradient and the xy gradient (the lap head moves
    the sampled points, so it is live), against the JAX four-tap gather;
    points inside, on the border and outside the map (zero padding)."""
    rng = np.random.default_rng(1)
    fmap = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)  # NHWC
    xy = rng.uniform(-1.3, 1.3, (2, 64, 2)).astype(np.float32)
    xy[:, :4] = [[-1, -1], [1, 1], [0.999, -0.999], [0, 0]]
    cot = rng.normal(size=(2, 64, 5)).astype(np.float32)

    ref, vjp = jax.vjp(jax_disn.bilinear_sample, jnp.asarray(fmap),
                       jnp.asarray(xy))
    ref_gmap, ref_gxy = vjp(jnp.asarray(cot))

    tmap = torch.tensor(fmap).permute(0, 3, 1, 2).requires_grad_()
    txy = torch.tensor(xy, requires_grad=True)
    got = disn.bilinear_sample(tmap, txy)
    gmap, gxy = torch.autograd.grad(got, (tmap, txy), torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gmap.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_gmap), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gxy.numpy(), np.asarray(ref_gxy), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(np.asarray(ref_gxy)).max() > 0.1


def _images(n=2, size=64, seed=2):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def test_encoder_forward_and_gradients_match_reference():
    """DISNEncoder at the tiny width: the global code and the five maps,
    and the gradients of a weighted sum of them with respect to every
    parameter and to the images (64x64, resized down to 32 first)."""
    imgs = _images()
    enc = jax_disn.DISNEncoder(**TINY)
    variables = jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))
    rng = np.random.default_rng(3)
    g_out, maps = jax.jit(enc.apply)(variables, jnp.asarray(imgs))
    weights = [rng.normal(size=m.shape).astype(np.float32)
               for m in [g_out, *maps]]

    def loss(params, x):
        g, ms = enc.apply({"params": params}, x)
        return sum(jnp.sum(w * o) for w, o in zip(weights, [g, *ms]))

    ref_gp, ref_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], jnp.asarray(imgs))

    port = disn.DISNEncoder(TINY["image_encoding_dim"],
                            TINY["local_feature_size"],
                            image_size=TINY["image_size"],
                            width=TINY["width"])
    load_flax_variables(port, jax.device_get(variables))
    x = torch.tensor(imgs, requires_grad=True)
    pg, pmaps = port(x)
    np.testing.assert_allclose(pg.detach().numpy(), np.asarray(g_out),
                               rtol=1e-5, atol=1e-6)
    assert len(pmaps) == 5
    for pm, m in zip(pmaps, maps):
        np.testing.assert_allclose(pm.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(m), rtol=1e-5, atol=1e-6)
    outs = [pg] + [pm.permute(0, 2, 3, 1) for pm in pmaps]
    total = sum(torch.sum(torch.tensor(w) * o) for w, o in zip(weights, outs))
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(total, [x, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_gx),
                               rtol=1e-4, atol=1e-5)
    ref_flat = _flat(jax.device_get(ref_gp))
    for (name, p), g in zip(params.items(), grads[1:]):
        mod, leaf = name.rsplit(".", 1)
        want = ref_flat[f"{mod}.{'kernel' if leaf == 'weight' else 'bias'}"]
        g = g.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        elif g.ndim == 2:
            g = g.T
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_decoder_forward_and_gradients_match_reference():
    """DISNDecoder: global + local SDF predictions and the gradients with
    respect to every parameter, the query points, the global code and the
    local samples."""
    rng = np.random.default_rng(4)
    q = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    glob = rng.normal(size=(2, 64)).astype(np.float32)
    local = rng.normal(size=(2, 50, 81)).astype(np.float32)
    cot = rng.normal(size=(2, 50, 3)).astype(np.float32)
    dec = jax_disn.DISNDecoder(out_features=3)
    variables = jax.jit(dec.init)(jax.random.PRNGKey(1), q, glob, local)

    @jax.jit
    def value_and_vjp(p, a, b, c, ct):
        out, vjp = jax.vjp(lambda *args: dec.apply({"params": args[0]},
                                                   *args[1:]), p, a, b, c)
        return out, vjp(ct)

    ref, ref_grads = value_and_vjp(variables["params"], jnp.asarray(q),
                                   jnp.asarray(glob), jnp.asarray(local),
                                   jnp.asarray(cot))

    port = disn.DISNDecoder(64, 81, 3)
    load_flax_variables(port, jax.device_get(variables))
    ins = [torch.tensor(a, requires_grad=True) for a in (q, glob, local)]
    out = port(*ins)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad(out, [*ins, *params.values()],
                                torch.tensor(cot))
    for g, want in zip(grads[:3], ref_grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    ref_flat = _flat(jax.device_get(ref_grads[0]))
    for (name, _), g in zip(params.items(), grads[3:]):
        mod, leaf = name.rsplit(".", 1)
        want = ref_flat[f"{mod}.{'kernel' if leaf == 'weight' else 'bias'}"]
        g = g.numpy().T if g.ndim == 2 else g.numpy()
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1),
                                   err_msg=name)


def _synthetic_vgg_state(width):
    """A torchvision VGG-16 state dict (its keys) at a width-scaled size,
    64 classes."""
    convs, hidden = disn.vgg_widths(width)
    ids = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    g = torch.Generator().manual_seed(0)
    state, c_in = {}, 3
    for tid, c_out in zip(ids, convs):
        state[f"features.{tid}.weight"] = torch.randn(
            (c_out, c_in, 3, 3), generator=g) * 0.1
        state[f"features.{tid}.bias"] = torch.randn(c_out, generator=g)
        c_in = c_out
    for tid, (o, i) in zip((0, 3, 6), ((hidden, c_in * 49),
                                       (hidden, hidden), (64, hidden))):
        state[f"classifier.{tid}.weight"] = torch.randn((o, i),
                                                        generator=g) * 0.01
        state[f"classifier.{tid}.bias"] = torch.randn(o, generator=g)
    return state


def test_vgg_loader_matches_reference(tmp_path):
    """load_vgg16_state_dict + inject_vgg16 give the encoder the state
    that the JAX package's load_vgg16_params + inject_vgg16 + the
    converter give it (classifier.0 mapped as it stands, flatten order
    included); a misfit shape and a missing VGG raise in both."""
    path = tmp_path / "vgg16.pth"
    torch.save(_synthetic_vgg_state(TINY["width"]), path)

    enc = jax_disn.DISNEncoder(**TINY)
    variables = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    injected = jax_port.inject_vgg16(
        {"params": {"enc": variables["params"]}},
        jax_port.load_vgg16_params(str(path)), encoder="enc")

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = disn.DISNEncoder(
                TINY["image_encoding_dim"], TINY["local_feature_size"],
                image_size=TINY["image_size"], width=TINY["width"])

    port = Holder()
    want = flax_to_state_dict(jax.device_get(injected), port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    disn_port.inject_vgg16(port, disn_port.load_vgg16_state_dict(str(path)),
                           encoder="enc")
    for key, value in port.state_dict().items():
        assert torch.equal(value, want[key]), key
        assert not torch.equal(value, before[key]), key

    wide = _synthetic_vgg_state(0.1)
    with pytest.raises(ValueError, match="checkpoint"):
        disn_port.inject_vgg16(port, wide, encoder="enc")
    with pytest.raises(ValueError, match="checkpoint"):
        jax_port.inject_vgg16(injected, jax_port.vgg16_flax_params(
            {k: v.numpy() for k, v in wide.items()}), encoder="enc")
    with pytest.raises(KeyError, match="use_disn"):
        disn_port.inject_vgg16(port, wide, encoder="encoder_pos")


def test_image_render_matches_reference():
    verts, faces = random_shape(3, level=1)
    cam = jax_render.random_camera(np.random.default_rng(7))
    np.testing.assert_array_equal(
        image_render.random_camera(np.random.default_rng(7)), cam)
    ref = jax_render.render_mesh_image(verts.astype(np.float32), faces, cam,
                                       48, 40)
    got = image_render.render_mesh_image(verts.astype(np.float32), faces,
                                         cam, 48, 40)
    np.testing.assert_array_equal(got, ref)
    assert (np.abs(got - 1.0) > 0.05).any()  # not all background


def test_make_example_with_image_matches_reference():
    """The camera is drawn after the surface and SDF draws, so every array
    (surface, SDF, occupancy, image, camera) is the reference's."""
    verts, faces = random_shape(5, level=1)
    ref = jax_pipeline.make_example(verts, faces, 300, 200,
                                    np.random.default_rng(9),
                                    occ_grid_res=16, with_image=True)
    got = pipeline.make_example(verts, faces, 300, 200,
                                np.random.default_rng(9), occ_grid_res=16,
                                with_image=True)
    assert set(got) == set(ref) and {"imgs", "cam_matrix"} <= set(got)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].dtype == value.dtype, key
    assert got["imgs"].shape == (64, 64, 3)
