"""``portfolio.sharded_chain_batch`` of the port on the CPU: one [B, V+1]
bool block per device, the blocks together the one-device draw of D*B
chains (the reference's SPMD draw gives the same chains whatever the
device count), seeded, on the device each was asked for."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.core.sat.portfolio import sharded_chain_batch as ref_batch
from repro_torch.core.sat.portfolio import sharded_chain_batch
from repro_torch.device import DeviceUnavailable

repro_torch.set_default_device("cpu")


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_blocks_are_the_one_device_draw_split(n_devices):
    blocks = sharded_chain_batch(40, 5, seed=3,
                                 devices=["cpu"] * n_devices)
    assert len(blocks) == n_devices
    for blk in blocks:
        assert blk.shape == (5, 41) and blk.dtype == torch.bool
        assert blk.device == torch.device("cpu")
    (whole,) = sharded_chain_batch(40, 5 * n_devices, seed=3)
    assert torch.equal(torch.cat(blocks), whole)


def test_draw_is_seeded_and_fair():
    a = sharded_chain_batch(255, 64, seed=7, devices=["cpu", "cpu"])
    b = sharded_chain_batch(255, 64, seed=7, devices=["cpu", "cpu"])
    c = sharded_chain_batch(255, 64, seed=8, devices=["cpu", "cpu"])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    share = float(torch.cat(a).float().mean())
    assert 0.47 < share < 0.53


def test_shape_and_dtype_equal_the_reference():
    """The reference shards [D*B, V+1] bools over a mesh axis; its draw
    (jax.random) differs from the port's, its shape and dtype do not."""
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    want = ref_batch(12, 4, seed=0, mesh=mesh)
    got = torch.cat(sharded_chain_batch(12, 4, seed=0, devices=["cpu"]))
    assert tuple(got.shape) == want.shape and want.dtype == jnp.bool_
    assert np.asarray(want).dtype == got.numpy().dtype


def test_bad_requests_raise():
    with pytest.raises(ValueError):
        sharded_chain_batch(10, 0, seed=0)
    with pytest.raises(ValueError):
        sharded_chain_batch(10, 4, seed=0, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailable):
            sharded_chain_batch(10, 4, seed=0, devices=["cuda:0"])
