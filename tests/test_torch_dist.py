"""The port's collectives, pipeline and meshes.

``quantize_int8``/``dequantize_int8`` are held bit-equal to the JAX
functions.  ``compressed_psum``, ``flash_decode_combine``,
``pipeline_apply`` and ``make_mesh_shape`` run over 4 gloo ranks,
spawned once for the module with a ``file://`` rendezvous in a temporary
directory, and are held to plain single-process oracles (the JAX
package's own multi-device legs, ``test_shard_map_collectives_subprocess``
and ``test_small_mesh_dryrun_subprocess``, fail on this tree).  Each rank
is joined with its own timeout, so a hang fails these tests and not the
suite."""

import multiprocessing as mp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.dist.collectives import dequantize_int8 as j_dequantize_int8
from repro.dist.collectives import quantize_int8 as j_quantize_int8

from repro_torch.dist.collectives import dequantize_int8, quantize_int8

WORLD = 4
JOIN_S = 120


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64, 256)) * 0.01).astype(np.float32)
    x[3] = 0.0                                    # an all-zero row: scale 1
    x[5, :4] = [127.0, 2.5, -3.5, 0.5]            # ties round half to even
    x[5, 4:] = 0.0
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    assert list(q[5, :4]) == [127, 2, -4, 0]
    d = dequantize_int8(q, s)
    assert np.array_equal(d.numpy(), np.asarray(j_dequantize_int8(jq, js)))
    rel = float((d - torch.from_numpy(x)).abs().max()
                / np.abs(x).max())
    assert rel < 1e-2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of WORLD gloo processes."""
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_rank,
                         args=(r, WORLD, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    hung = []
    for r, p in enumerate(procs):
        p.join(JOIN_S)
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_group_size(ranks):
    assert [r["size"] for r in ranks] == [WORLD] * WORLD


def test_compressed_psum_matches_oracle(ranks):
    """Every rank holds the sum of the dequantized int8 rows of every
    rank: bit-equal to the same sum in one process, and within 2e-2 of
    the exact f32 sum (the JAX test's bound)."""
    xs = [W.psum_input(r) for r in range(WORLD)]
    oracle = torch.sum(torch.stack([dequantize_int8(*quantize_int8(x))
                                    for x in xs]), dim=0)
    exact = torch.stack(xs).sum(0)
    for r in ranks:
        assert torch.equal(r["psum"], oracle)
    err = float((ranks[0]["psum"] - exact).abs().max() / exact.abs().max())
    assert err < 2e-2, err


def test_flash_decode_combine_matches_softmax(ranks):
    q, k, v = W.decode_inputs()
    scores = torch.einsum("bhd,bshd->bhs", q, k)
    ref = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), v)
    for r in ranks:
        np.testing.assert_allclose(r["combine"].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_pipeline_matches_serial(ranks):
    """GPipe over 4 stages: the last rank holds the serial stack's
    outputs; the other ranks hold zeros."""
    w, b, x = W.pipeline_inputs(WORLD)
    ref = x
    for s in range(WORLD):
        ref = W.stage_fn((w[s], b[s]), ref)
    np.testing.assert_allclose(ranks[-1]["pipe"].numpy(), ref.numpy(),
                               rtol=1e-6, atol=1e-6)
    for r in ranks[:-1]:
        assert not r["pipe"].any()


def test_mesh_over_the_world(ranks):
    """A (2, 2) mesh over the 4 ranks builds; a shape whose product is
    not the world's size, and the production mesh, raise."""
    for r in ranks:
        assert r["mesh"] == ((2, WORLD // 2), ("data", "model"))
        assert all(e and "ranks" in e for e in r["mesh_errors"]), \
            r["mesh_errors"]


def test_mesh_shape_checked_on_one_process():
    from repro_torch.launch.mesh import make_mesh_shape

    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_shape((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="length"):
        make_mesh_shape((1,), ("data", "model"), "cpu")


def test_mesh_needs_a_card_unless_the_cpu_is_asked_for():
    """``launch.mesh`` resolves its device as every entry point does:
    ``None`` is the card, and raises without one (it once built a gloo
    CPU mesh instead); ``"cpu"`` and ``"meta"`` only when asked for."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_shape((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh(fake=True)
    assert not dist.is_initialized()
    mesh = make_production_mesh(device_type="meta", fake=True)
    try:
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 256
    finally:
        dist.destroy_process_group()
