"""The port's tensor-parallel generator and sequence-parallel landmark
branch (``parallel.py``) and its multi-device dry run (``multichip.py``)
against the JAX package's modes of ``__graft_entry__.py:dryrun_multichip``,
on the CPU over gloo ranks spawned on the CPU:

- ``tensor_parallel_generator`` on a (2, 2) grid of 4 ranks: the trident
  generator (ngf 8, 3 blocks) with seeded random weights on 4 frames at
  64^2, against JAX's run with ``tp_spec``'s shardings on a (2, 2) mesh
  and against the one-rank generator, within 1e-4
  (``tests/test_torch_models.py``'s generator bar); the port slices the
  convs that ``tp_spec`` shards, and no other;
- ``sequence_parallel_pos`` over 2 and 4 ranks at T = 8n: against the
  one-rank ``Audio2landmarkPos`` and JAX's run with time sharded over an
  n-device mesh, within 1e-4 (``tests/test_torch_audio_landmark.py``'s
  bar), with the attention's output projection scaled so that a segment
  cut into per-rank sequences would fail;
- ``dryrun_multichip(2)`` and ``dryrun_multichip(4)`` on the CPU;
- GPipe over 3 of 4 ranks, TP and SP in one spawn
  (``utils/smoke.py:jobs_rank``), as the one-rank-a-card tests of
  ``tests/test_torch_cuda.py`` run them, against the modules in one
  process.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models.audio2landmark import Audio2landmarkPos
from animateportrait_tpu_torch.models.gan import TridentGeneratorFullIFW
from animateportrait_tpu_torch.multichip import (
    ATTN_GAIN, dryrun_multichip, gain_attention, generator_inputs,
    pos_inputs, sp_run, tp_run)
from animateportrait_tpu_torch.parallel import tp_sharded
from animateportrait_tpu_torch.utils import distributed as ddp
from animateportrait_tpu_torch.utils.smoke import (
    gpipe_run, init_random_, jobs_rank, resnet_blocks)
from torch_port_helpers import maxdiff, nchw

ATOL = 1e-4
G_KW = dict(output_nc=1, ngf=8, n_blocks=3, div=3, disp=3)
SPAWN_TIMEOUT = 180           # s, for the ranks of one spawn


def _spawned(tmp_path, n, jobs):
    ddp.spawn(jobs_rank, ["cpu"] * n, jobs, str(tmp_path),
              timeout=SPAWN_TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


def test_tensor_parallel_generator_matches_jax_and_one_rank(tmp_path):
    from animateportrait_tpu.models.gan import TridentGeneratorFullIFW as JG

    h, n = 64, 4
    rng = np.random.default_rng(0)
    args = [rng.uniform(-1, 1, (n, h, h, c)).astype(np.float32)
            for c in (3, 1, 1, 2)]
    args += [rng.standard_normal((n, h, h, 2)).astype(np.float32),
             np.ones((n, h, h, 1), np.float32)]
    jg = JG(**G_KW)
    v = random_variables(lambda: jg.init(jax.random.key(0),
                                         *(jnp.asarray(a) for a in args)),
                         seed=3)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(-1, 2),
                ("data", "model"))
    n_tp = 0

    def tp_spec(path, x):          # __graft_entry__.py:131-136
        nonlocal n_tp
        if getattr(path[-1], "key", None) == "kernel" and x.ndim == 4 \
                and x.shape[-1] % 2 == 0:
            n_tp += 1
            return NamedSharding(mesh, P(None, None, None, "model"))
        return NamedSharding(mesh, P())

    jv = jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(x, tp_spec(p, x)), v)
    jargs = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data")))
             for a in args]
    want = np.asarray(jax.jit(lambda v, *a: jg.apply(v, *a))(jv, *jargs))

    sd = from_jax.trident_state_dict(v, n_blocks=3, div=3, disp=3)
    g = TridentGeneratorFullIFW(**G_KW)
    g.load_state_dict(sd)
    targs = [nchw(a).numpy() for a in args[:3]] + [args[3]] + [
        nchw(a).numpy() for a in args[4:]]
    with torch.no_grad():
        one = g.eval()(*(torch.as_tensor(a) for a in targs))
    ranks = [rec["tp"] for rec in _spawned(
        tmp_path, n, {"tp": (tp_run, ((2, 2), G_KW, sd, targs))})]
    assert sum(map(tp_sharded, g.modules())) == n_tp > 0
    assert maxdiff(one.permute(0, 2, 3, 1), want) <= ATOL
    for rec in ranks:
        assert rec["backend"] == "gloo" and rec["sliced"] == n_tp
        assert rec["y"].shape == (n, 1, h, h)
        assert maxdiff(rec["y"].permute(0, 2, 3, 1), want) <= ATOL
        assert maxdiff(rec["y"], one) <= ATOL
        assert torch.equal(rec["y"], ranks[0]["y"])


@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_pos_matches_jax_and_one_rank(tmp_path, n):
    from animateportrait_tpu.models.audio2landmark import (
        Audio2landmarkPos as JPos)

    T = 8 * n
    rng = np.random.default_rng(n)
    args = [rng.standard_normal((T, 18, 80)).astype(np.float32),
            rng.standard_normal((T, 256)).astype(np.float32),
            rng.standard_normal((1, 204)).astype(np.float32),
            rng.standard_normal((T, 128)).astype(np.float32)]
    jpos = JPos()
    v = random_variables(lambda: jpos.init(
        jax.random.key(0), *(jnp.asarray(a) for a in args)), seed=1)
    # the attention's output projection x ATTN_GAIN: at random weights the
    # residual stream (the embedding x 8) drowns what attention adds, and
    # a segment cut into separate sequences would pass
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: x * ATTN_GAIN if "['attn']['out']['kernel']"
        in jax.tree_util.keystr(p) else x, v)
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    seq, repl = NamedSharding(mesh, P("seq")), NamedSharding(mesh, P())
    jargs = [jax.device_put(jnp.asarray(a), repl if i == 2 else seq)
             for i, a in enumerate(args)]
    want = np.asarray(jax.jit(lambda v, *a: jpos.apply(v, *a)[0])(
        jax.device_put(v, repl), *jargs))

    sd = from_jax.pos_state_dict(v)
    pos = Audio2landmarkPos()
    pos.load_state_dict(sd)
    with torch.no_grad():
        one = pos.eval()(*(torch.as_tensor(a) for a in args))[0]
    ranks = [rec["sp"] for rec in _spawned(
        tmp_path, n, {"sp": (sp_run, (sd, args))})]
    assert maxdiff(one, want) <= ATOL
    for rec in ranks:
        assert rec["y"].shape == (T, 204)
        assert maxdiff(rec["y"], want) <= ATOL
        assert maxdiff(rec["y"], one) <= ATOL
        assert torch.equal(rec["y"], ranks[0]["y"])
    # each segment is one attention sequence: the first rank's frames as a
    # sequence of their own fail the bar
    with torch.no_grad():
        alone = pos(*(torch.as_tensor(a[:T // n]) if i != 2
                      else torch.as_tensor(a) for i, a in enumerate(args)))[0]
    assert maxdiff(alone, one[:T // n]) > 3 * ATOL


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n, capfd):
    recs = dryrun_multichip(n, "cpu")
    assert f"dryrun_multichip({n}) OK — " in capfd.readouterr().out
    assert len(recs) == n
    for rec in recs:
        assert rec["backend"] == "gloo"
        assert set(rec) >= {"step", "sp", "pp"} | ({"tp"} if n % 2 == 0
                                                  else set())
        b = rec["step"]["bytes"]
        assert b["sharded"] * n == b["unsharded"] > 0
    assert recs[0]["step"]["metrics"] == recs[-1]["step"]["metrics"]


def test_dryrun_multichip_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_several_modes_in_one_spawn(tmp_path):
    """GPipe over the first 3 of 4 ranks (a subgroup: the fourth rank
    returns None), TP on a (2, 2) grid and SP over the 4 ranks, in one
    spawn of ``jobs_rank``: each within its bar of the one-process
    module."""
    from animateportrait_tpu_torch.models.gan import ResnetBlock
    from animateportrait_tpu_torch.parallel import seq_apply

    n = 4
    blocks = resnet_blocks(8, 3, seed=6)
    x = np.random.default_rng(7).standard_normal((6, 8, 8, 8)).astype(
        np.float32)
    g = init_random_(TridentGeneratorFullIFW(**G_KW),
                     torch.Generator().manual_seed(2))
    frames = generator_inputs(np.random.default_rng(3), n, 32)
    sd = gain_attention(init_random_(
        Audio2landmarkPos(), torch.Generator().manual_seed(4)).state_dict())
    segment = pos_inputs(np.random.default_rng(5), 8 * n)
    jobs = {"gpipe": (gpipe_run, (blocks, x, [3], 3)),
            "tp": (tp_run, ((2, 2), G_KW, g.state_dict(), frames)),
            "sp": (sp_run, (sd, segment))}
    ranks = _spawned(tmp_path, n, jobs)
    mods = []
    for b in blocks:
        block = ResnetBlock(8)
        block.load_state_dict(b)
        mods.append(block.eval())
    xt = torch.as_tensor(x)
    seq = torch.cat([seq_apply(mods, c) for c in xt.chunk(3)])
    pos = Audio2landmarkPos()
    pos.load_state_dict(sd)
    with torch.no_grad():
        one_g = g.eval()(*(torch.as_tensor(a) for a in frames))
        one_pos = pos.eval()(*(torch.as_tensor(a) for a in segment))[0]
    assert ranks[3]["gpipe"] is None
    for rec in ranks[:3]:
        assert rec["gpipe"]["backend"] == "gloo"
        assert torch.allclose(rec["gpipe"]["y"][3], seq, rtol=2e-5,
                              atol=2e-5)
    for rec in ranks:
        assert maxdiff(rec["tp"]["y"], one_g) <= ATOL
        assert rec["tp"]["sliced"] > 0
        assert maxdiff(rec["sp"]["y"], one_pos) <= ATOL
