"""Port parity: the torch RAFT checkpoint converter (models/convert_raft.py).

A torch RAFT checkpoint is not in the repo and is not fetched, so, as
tests/test_data_convert.py does, the torch-shaped state dict is made from
flax variables by `fake_torch_state_dict_from_flax`. The raft-things
variables are random values of the shapes JAX's init gives (no compile).
Everything here is exact: same trees, same bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore, msgpack_serialize

from particlesfm_tpu.models import convert_raft as jconv
from particlesfm_tpu.models.raft import RAFT as JRAFT
from particlesfm_tpu_torch.io.checkpoint import raft_state_dict_from_jax
from particlesfm_tpu_torch.models import convert_raft as pconv
from particlesfm_tpu_torch.models.raft import RAFT
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda: JRAFT().init(jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                                                 jnp.zeros((64, 64, 3)), iters=1))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def test_fake_state_dict_and_convert_match_jax(variables):
    """fake_torch_state_dict_from_flax and convert_torch_raft of both packages
    give the same keys and arrays; the conversion returns the variables."""
    sd_j = jconv.fake_torch_state_dict_from_flax(variables)
    sd_p = pconv.fake_torch_state_dict_from_flax(variables)
    assert sorted(sd_j) == sorted(sd_p)
    for k in sd_j:
        np.testing.assert_array_equal(sd_p[k], sd_j[k], err_msg=k)
    sd = {f"module.{k}": v for k, v in sd_j.items()}      # DataParallel prefix
    out_j, out_p = jconv.convert_torch_raft(sd), pconv.convert_torch_raft(sd)
    assert msgpack_serialize(out_p) == msgpack_serialize(out_j)
    assert msgpack_serialize(out_p) == msgpack_serialize(jax.device_get(variables))


def test_convert_cli_writes_what_jax_writes(variables, tmp_path):
    """The CLI on a torch checkpoint file: the msgpack bytes flax writes for
    the JAX conversion, and the result loads strictly into the port's
    raft-things RAFT (batch-norm cnet with its running statistics)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jconv.fake_torch_state_dict_from_flax(variables).items()}
    torch.save(sd, tmp_path / "raft-things.pth")
    assert pconv.main([str(tmp_path / "raft-things.pth"), str(tmp_path / "out.msgpack")]) == 0
    blob = (tmp_path / "out.msgpack").read_bytes()
    ref = jconv.convert_torch_raft({k: v.numpy() for k, v in sd.items()})
    assert blob == msgpack_serialize(ref)
    tree = msgpack_restore(blob)
    model = RAFT()
    model.load_state_dict(raft_state_dict_from_jax(tree["params"], tree["batch_stats"]),
                          strict=True)
