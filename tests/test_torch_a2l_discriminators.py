"""Module1's three training discriminators (``models/audio2landmark.py``:
``DiscriminatorMLP``, ``TransformerDT``, ``DiscriminatorGRU``) against the
JAX package's on the same weights (JAX random variables carried over by
``io/from_jax.py``) and inputs, at the reference's widths (they are
small): the forward and the gradients of <cotangent, output> with respect
to every input, fp32, rtol 1e-5 and atol 1e-6. ``TransformerDT`` runs with
T above and below its window (64), ``DiscriminatorGRU`` with pooled
lengths (T - 3) above and below its window (32), and each once with
``win_step`` 2."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animateportrait_tpu.models import audio2landmark as ja
from animateportrait_tpu.utils.smoke import random_variables
from animateportrait_tpu_torch.io import from_jax
from animateportrait_tpu_torch.models import audio2landmark as ta

TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (JAX module, port module, converter, input widths)
NETS = {
    "mlp": (ja.DiscriminatorMLP, ta.DiscriminatorMLP,
            from_jax.discriminator_mlp_state_dict, (204,)),
    "transformer_dt": (ja.TransformerDT, ta.TransformerDT,
                       from_jax.transformer_dt_state_dict, (204, 128)),
    "gru": (ja.DiscriminatorGRU, ta.DiscriminatorGRU,
            from_jax.discriminator_gru_state_dict, (256, 204)),
}
CASES = [("mlp", 12, 1), ("transformer_dt", 20, 1), ("transformer_dt", 70, 1),
         ("transformer_dt", 70, 2), ("gru", 20, 1), ("gru", 50, 1),
         ("gru", 50, 2)]


@pytest.mark.parametrize("name,T,win_step", CASES)
def test_discriminator_forward_and_input_gradients_match_jax(name, T,
                                                             win_step):
    jcls, tcls, convert, widths = NETS[name]
    rng = np.random.default_rng(T + win_step)
    xs = [rng.standard_normal((T, w)).astype(np.float32) for w in widths]
    kw = {} if name == "mlp" else {"win_step": win_step}
    jm = jcls()
    v = random_variables(lambda: jm.init(jax.random.key(0),
                                         *map(jnp.asarray, xs)))
    ref, vjp = jax.vjp(lambda *a: jm.apply(v, *a, **kw),
                       *map(jnp.asarray, xs))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(cot))

    tm = tcls()
    tm.load_state_dict(convert(v))
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = tm(*txs, **kw)
    grads = torch.autograd.grad(out, txs, torch.from_numpy(cot))
    assert out.shape == ref.shape
    if name == "transformer_dt":
        assert out.shape[0] == (1 if T <= 64 else T - 64)
    if name == "gru":
        assert out.shape[0] == (1 if T - 3 <= 32 else T - 3 - 32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for g, r in zip(grads, ref_grads):
        assert float(np.abs(np.asarray(r)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
