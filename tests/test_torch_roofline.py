"""The port's roofline module against the JAX package: ``param_counts`` and
``model_flops`` equal the reference's for every architecture at its
published and smoke widths and every kind; ``terms`` at the H100 SXM's
constants, with a null collective term where the port has no wire bytes
(it has no HLO to read collectives from)."""
import pytest

from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch, smoke):
    cfg, ref = get_config(arch), ref_get_config(arch)
    if smoke:
        cfg, ref = cfg.smoke(), ref.smoke()
    assert roofline.param_counts(cfg) == ref_roofline.param_counts(ref)
    for kind in ("train", "prefill", "decode"):
        for tokens in (1, 128, 4 * 2048, 256 * 4096):
            assert roofline.model_flops(cfg, kind, tokens) == \
                ref_roofline.model_flops(ref, kind, tokens)


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989.4e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    # no TPU v5e number left in the port
    assert {roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW}.isdisjoint(
        {ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.ICI_BW})


@pytest.mark.parametrize("flops,nbytes,wire,bottleneck", [
    (989.4e12, 3.35e12 / 2, 450e9 / 4, "compute_s"),
    (989.4e12 / 8, 3.35e12, 450e9 / 2, "memory_s"),
    (1e9, 1e9, 450e9 * 3, "collective_s"),
])
def test_terms_at_h100_constants(flops, nbytes, wire, bottleneck):
    t = roofline.terms(flops, nbytes, wire)
    assert t["compute_s"] == flops / 989.4e12
    assert t["memory_s"] == nbytes / 3.35e12
    assert t["collective_s"] == wire / 450e9
    assert t["bottleneck"] == bottleneck
    assert t["step_s"] == max(t["compute_s"], t["memory_s"],
                              t["collective_s"])
    # the same structure as the reference's terms
    assert set(t) == set(ref_roofline.terms(flops, nbytes, wire))


@pytest.mark.parametrize("flops,nbytes,bottleneck", [
    (989.4e12, 3.35e12 / 2, "compute_s"), (1.0, 3.35e12, "memory_s")])
def test_collective_term_is_null_without_wire_bytes(flops, nbytes,
                                                    bottleneck):
    """The port counts no collectives: the term is None and the bound is
    taken over the terms it has."""
    t = roofline.terms(flops, nbytes, None)
    assert t["collective_s"] is None
    assert t["bottleneck"] == bottleneck
    assert t["step_s"] == max(flops / 989.4e12, nbytes / 3.35e12)
    assert not hasattr(roofline, "parse_collectives")
