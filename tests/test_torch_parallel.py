"""The port's GPipe schedule (``parallel.py``) and its data-parallel
renderer (``Module2Renderer(data_parallel=True)``) against the JAX
package's, on the CPU:

- ``gpipe_apply`` on gloo ranks spawned on the CPU, one stage each, on the
  ``ResnetBlock`` weights of JAX's ``gpipe_apply`` run on the conftest's
  virtual mesh (carried over by ``io/from_jax.py``), at (P, M) = (2, 2),
  (4, 4) and (4, 8): every rank's output within rtol = atol = 2e-5 of
  JAX's (``tests/test_parallel.py``'s bar), the same output on every rank,
  and the "not divisible" error of an indivisible batch; ``seq_apply``
  against JAX's ``_seq_apply``;
- the renderer on JAX's 10-frame case (``tests/test_render.py``'s data-
  parallel test): two replicas on the CPU against one within atol 2e-5,
  ``frame_batch`` rounded up to the replicas, and one replica against the
  JAX renderer at the renderer's 40 dB bar.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.gan import ResnetBlock
from animateportrait_tpu_torch.parallel import (
    resnet_stage, seq_apply, stage_blocks)
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.smoke import gpipe_run, jobs_rank
from torch_port_helpers import nchw, nhwc, psnr

TOL = dict(rtol=2e-5, atol=2e-5)
DIM, BLOCKS_PER_STAGE, BATCH = 8, 2, 16
CASES = [(2, 2), (4, 4), (4, 8)]
SPAWN_TIMEOUT = 120          # s, for the ranks of one spawn


def _jax_blocks(n_stages: int):
    from animateportrait_tpu.models.gan import ResnetBlock as JBlock

    block = JBlock(dim=DIM)
    keys = jax.random.split(jax.random.key(0), n_stages * BLOCKS_PER_STAGE)
    return block, [block.init(k, jnp.zeros((1, 8, 8, DIM))) for k in keys]


def _port_blocks(params) -> list:
    out = []
    for v in params:
        block = ResnetBlock(DIM)
        block.load_state_dict(from_jax.resnet_block_state_dict(v))
        out.append(block.eval())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For P = 2 and 4: JAX's ``gpipe_apply`` output at each M of CASES on
    a P-device mesh, and each port rank's record (``gpipe_run``)."""
    from animateportrait_tpu.parallel import (
        gpipe_apply, resnet_stage_fn, stack_stage_params)

    x = np.asarray(jax.random.normal(jax.random.key(1),
                                     (BATCH, 8, 8, DIM)))
    out = {}
    for p in sorted({p for p, _ in CASES}):
        ms = [m for pp, m in CASES if pp == p]
        block, params = _jax_blocks(p)
        stacked = stack_stage_params([
            stack_stage_params(params[s * BLOCKS_PER_STAGE:
                                      (s + 1) * BLOCKS_PER_STAGE])
            for s in range(p)])
        mesh = Mesh(np.array(jax.devices()[:p]), ("pipe",))
        stage_fn = resnet_stage_fn(lambda v, h: block.apply(v, h))
        want = {m: np.asarray(gpipe_apply(stage_fn, stacked, jnp.asarray(x),
                                          mesh, num_microbatches=m))
                for m in ms}
        d = tmp_path_factory.mktemp(f"gpipe{p}")
        sds = [from_jax.resnet_block_state_dict(v) for v in params]
        ddp.spawn(jobs_rank, ["cpu"] * p,
                  {"gpipe": (gpipe_run, (sds, nchw(x).numpy(), ms))}, str(d),
                  timeout=SPAWN_TIMEOUT)
        ranks = [torch.load(d / f"rank{r}.pt")["gpipe"] for r in range(p)]
        out[p] = dict(want=want, ranks=ranks, params=params, block=block,
                      stacked=stacked, x=x)
    return out


@pytest.mark.parametrize("n_stages,microbatches", CASES)
def test_gpipe_matches_jax(runs, n_stages, microbatches):
    run = runs[n_stages]
    for rank in run["ranks"]:
        got = nhwc(rank["y"][microbatches])
        np.testing.assert_allclose(got, run["want"][microbatches], **TOL)


def test_gpipe_output_is_on_every_rank(runs):
    """The last stage's output reaches every rank over gloo, bit for
    bit."""
    for run in runs.values():
        last = run["ranks"][-1]
        for rank in run["ranks"]:
            assert rank["backend"] == "gloo"
            for m, y in rank["y"].items():
                assert y.shape == (BATCH, DIM, 8, 8)
                assert torch.equal(y, last["y"][m])


def test_gpipe_rejects_indivisible_batch(runs):
    for p, run in runs.items():
        for rank in run["ranks"]:
            assert rank["indivisible"] == (
                f"batch 1 not divisible by {p + 1} microbatches")


def test_seq_apply_matches_jax(runs):
    from animateportrait_tpu.parallel import _seq_apply

    run = runs[4]
    block = run["block"]
    want = _seq_apply(lambda v, h: block.apply(v, h), run["stacked"],
                      jnp.asarray(run["x"]))
    got = seq_apply(_port_blocks(run["params"]), nchw(run["x"]))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_stage_blocks_split_in_order():
    blocks = list(range(12))
    assert [stage_blocks(blocks, 4, s) for s in range(4)] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    with pytest.raises(ValueError, match="equal stages"):
        stage_blocks(list(range(10)), 4, 0)
    mods = [ResnetBlock(4) for _ in range(2)]
    stage = resnet_stage(mods)
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(stage(x), mods[1](mods[0](x)))


# --- the data-parallel renderer ----------------------------------------------

CS = 64


@pytest.fixture(scope="module")
def render_case():
    """JAX's 10-frame data-parallel case (tests/test_render.py): its nets
    initialised as that test does, the port's from the same variables."""
    from animateportrait_tpu.models.flowunet import FlowUnet as JF
    from animateportrait_tpu.models.gan import (
        ResnetStyle2Generator as JS, TridentGeneratorFullIFW as JT)
    from animateportrait_tpu.models.modnet import MODNet as JM
    from animateportrait_tpu.pipeline.render import (
        Module2Renderer as JR, RendererVariables)
    from animateportrait_tpu_torch.models.flowunet import FlowUnet
    from animateportrait_tpu_torch.models.gan import (
        ResnetStyle2Generator, TridentGeneratorFullIFW)
    from animateportrait_tpu_torch.models.modnet import MODNet

    k = jax.random.key(0)
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    gen_v = JT(output_nc=1, ngf=8, div=3, disp=3).init(
        k, z(1, CS, CS, 3), z(1, CS, CS, 1), z(1, CS, CS, 1),
        z(1, CS, CS, 2), z(1, CS, CS, 2), z(1, CS, CS, 1))
    flow_v = JF(nf=4, max_nf=64).init(k, z(1, 224, 224, 136))
    mod_v = JM().init(k, z(1, CS, CS, 3))
    static_v = JS(ngf=8).init(k, z(1, 512, 512, 3), z(1, 128, 128, 3))
    jr = JR(RendererVariables(generator=gen_v, flowunet=flow_v,
                              modnet=mod_v, static_drawing=static_v),
            style="drawing", ngf=8, flowunet=JF(nf=4, max_nf=64),
            static_g=JS(ngf=8), crop_size=CS, frame_batch=8)

    rng = np.random.default_rng(0)
    photo = rng.uniform(-1, 1, (CS, CS, 3)).astype(np.float32)
    theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    a68 = np.stack([32 + 15 * np.cos(theta),
                    32 + 15 * np.sin(theta)], -1).astype(np.float32)
    tb = np.stack([a68 + 0.2 * i for i in range(10)]).astype(np.float32)

    def nets():
        gen = TridentGeneratorFullIFW(output_nc=1, ngf=8, div=3, disp=3)
        gen.load_state_dict(from_jax.trident_state_dict(gen_v, 9, 3, 3))
        flow = FlowUnet(nf=4, max_nf=64)
        flow.load_state_dict(from_jax.flowunet_state_dict(flow_v))
        mod = MODNet()
        mod.load_state_dict(from_jax.modnet_state_dict(mod_v))
        static = ResnetStyle2Generator(ngf=8)
        static.load_state_dict(from_jax.style2_state_dict(static_v))
        return gen, flow, mod, static

    return dict(jr=jr, nets=nets, inputs=(photo, a68, tb))


def test_render_dp_matches_one_replica_and_jax(render_case):
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    photo, a68, tb = render_case["inputs"]
    one = Module2Renderer(*render_case["nets"](), frame_batch=8,
                          device="cpu", crop_size=CS)
    two = Module2Renderer(*render_case["nets"](), frame_batch=7,
                          device="cpu", crop_size=CS, data_parallel=True,
                          devices=["cpu", "cpu"])
    assert len(one.replicas) == 1 and len(two.replicas) == 2
    assert two.frame_batch == 8          # rounded up to the replicas
    assert two.replicas[1][0] is not two.g      # a replica, not a share
    with torch.no_grad():
        f1 = one(photo, a68, tb)
        f2 = two(photo, a68, tb)
    assert f1.shape == f2.shape == (10, CS, CS, 1)
    np.testing.assert_allclose(f2, f1, atol=2e-5)
    ref = np.asarray(render_case["jr"](photo, a68, tb))
    assert psnr(f1, ref) >= 40.0


def test_render_dp_on_the_cpu_is_one_replica(render_case):
    """Without ``devices``, the CPU is one device: one replica, the
    single-device path and its frame batch."""
    from animateportrait_tpu_torch.pipeline.render import Module2Renderer

    r = Module2Renderer(*render_case["nets"](), frame_batch=7,
                        device="cpu", crop_size=CS, data_parallel=True)
    assert len(r.replicas) == 1 and r.frame_batch == 7
    assert r.replicas[0][:2] == (r.g, r.flowunet)
