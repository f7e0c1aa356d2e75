"""The port's ResNet family: ResNet-50's fp32 forward against the JAX
package's, and every constructor's architecture.

ResNet-50 (NHWC, `stem_s2d`, 1000 classes), same weights and batch (8 x
32 x 32), fp32: the eval forward's logits within 1e-4 relative (the
errors seen are ~1e-6); the training forward's logits and its
BatchNorm statistics within 2e-3. The training forward normalises
layer4's 1 x 1 planes over 8 samples and is ill-conditioned in fp32:
the port's fp32 logits differ from its own fp64 ones by 1.8e-4, and
the two packages' fp32 logits by 6e-4 (the fp64 lockstep of
`test_torch_resnet50.py` holds the same forward within 1e-9). The
constructors from `resnet18` to `resnext152_32x4d` build the reference's
networks: their parameter counts are the published ones (torchvision's
counts of the same networks; the ResNeXt variants torchvision lacks from
the block arithmetic, which reproduces the published counts), and a
ResNeXt is ResNet-50's modules with grouped 3 x 3 convolutions.
Constructor options: `dtype` (parameters only; buffers stay fp32),
`num_classes=0`, `with_pool=False`, the seed, and `pretrained=True`
raising.
"""
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import resnet50 as jax_resnet50
from paddle_tpu.nn.layer import functional_call as jax_functional_call
from paddle_tpu_torch import models
from paddle_tpu_torch.models import load_jax_state, resnet50
from port_resnet import images, jax_model, port_twin, rel_err, worst
from port_threads import one_torch_thread  # noqa: F401

KW = dict(num_classes=1000, data_format="NHWC", stem_s2d=True)


def test_resnet50_forward_matches_jax():
    jm, P, B = jax_model(jax_resnet50, **KW)
    x, _ = images(8, 32, classes=1000)
    out, upd = jax_functional_call(jm, jm.raw_parameters(), jnp.asarray(x),
                                   buffers=jm.raw_buffers(), training=True)
    m = port_twin(resnet50, P, B, **KW)
    m.train()
    assert rel_err(m(torch.from_numpy(x)), out) < 2e-3
    assert worst(dict(m.named_buffers()), upd)[0] < 2e-3
    load_jax_state(m, P, B)
    jm.eval()
    m.eval()
    with torch.no_grad():
        assert rel_err(m(torch.from_numpy(x)), jm(jnp.asarray(x))) < 1e-4


def _bottleneck_count(layers, groups, width, classes=1000):
    """Parameters of a bottleneck ResNet(-Xt): stem, blocks, head."""
    n = 64 * 3 * 49 + 2 * 64
    inplanes = 64
    for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        w = int(planes * width / 64) * groups
        for b in range(blocks):
            n += inplanes * w + 2 * w + w * (w // groups) * 9 + 2 * w \
                + w * planes * 4 + 2 * planes * 4
            if b == 0:
                n += inplanes * planes * 4 + 2 * planes * 4
            inplanes = planes * 4
    return n + 2048 * classes + classes


COUNTS = {"resnet18": 11689512, "resnet34": 21797672, "resnet50": 25557032,
          "resnet101": 44549160, "resnet152": 60192808,
          "wide_resnet50_2": 68883240, "wide_resnet101_2": 126886696,
          "resnext50_32x4d": 25028904, "resnext101_32x4d": 44177704,
          "resnext50_64x4d": _bottleneck_count((3, 4, 6, 3), 64, 4),
          "resnext101_64x4d": 83455272,
          "resnext152_32x4d": _bottleneck_count((3, 8, 36, 3), 32, 4)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_constructor_builds_the_reference_architecture(name):
    m = getattr(models, name)(device="cpu")
    assert sum(p.numel() for p in m.parameters()) == COUNTS[name]
    assert all(b.dtype == torch.float32 for b in m.buffers())


def test_block_arithmetic_reproduces_the_published_counts():
    assert _bottleneck_count((3, 4, 6, 3), 1, 64) == COUNTS["resnet50"]
    assert _bottleneck_count((3, 4, 23, 3), 32, 4) == \
        COUNTS["resnext101_32x4d"]
    assert _bottleneck_count((3, 4, 23, 3), 64, 4) == \
        COUNTS["resnext101_64x4d"]


def test_resnext_is_resnet50_with_grouped_convolutions():
    """The JAX ResNeXt is the same classes (names) with `groups` and
    `width`: the 3 x 3 convolution of each bottleneck is grouped and
    its width is planes x width / 64 x groups."""
    base = dict(models.resnet50(num_classes=10, device="cpu")
                .named_parameters())
    m = models.resnext50_32x4d(num_classes=10, device="cpu")
    got = dict(m.named_parameters())
    assert list(got) == list(base)
    assert got["layer1.0.conv2.weight"].shape == (128, 4, 3, 3)
    assert got["layer4.2.conv3.weight"].shape == (2048, 1024, 1, 1)
    assert m.layer1[0].conv2.groups == 32


def test_constructor_options():
    m = resnet50(device="cpu", dtype="bfloat16", num_classes=0,
                 with_pool=False)
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in m.buffers()} == {torch.float32}
    m.eval()
    with torch.no_grad():
        out = m(torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16))
    assert out.shape == (1, 2048, 1, 1) and out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="download"):
        resnet50(pretrained=True, device="cpu")
    a = models.resnet18(seed=3, device="cpu")
    b = models.resnet18(seed=3, device="cpu")
    c = models.resnet18(seed=4, device="cpu")
    assert torch.equal(a.fc.weight, b.fc.weight)
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    assert torch.equal(a.fc.bias, torch.zeros(1000))
