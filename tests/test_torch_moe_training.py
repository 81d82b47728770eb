"""The MoE transformer trained 20 AdamW steps in both packages from one
init, on the CPU: the loss and the summed Switch aux loss agree step for
step (f32, relative 1e-3).

This settles whether the router collapse of the port's MoE flagship on
the card (its aux loss climbing over training) is the port's: the same
recipe, AdamW at ``pretrain``'s learning rate and ``moe_aux_weight``
0.01, runs here through the JAX package's ``transformer_train_step``
(optax ``adamw``) and the port's (``torch.optim.AdamW`` with optax's
defaults). Sizes: 4 experts, d_model 32, 2 layers, vocab 64, batch 8 of
33 tokens, made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=40,
          n_experts=4)
STEPS = 20


def _batches(seed=7, b=8, s=33):
    rng = np.random.RandomState(seed)
    # a skewed unigram stream, so the router has something to learn
    probs = rng.dirichlet(np.full(LM['vocab_size'], 0.3))
    return [rng.choice(LM['vocab_size'], size=(b, s), p=probs).astype(np.int32)
            for _ in range(STEPS)]


def _jax_run(params, config, batches, lr):
    optimizer = optax.adamw(lr)
    step = jt.transformer_train_step(config, optimizer)
    aux_of = jax.jit(lambda p, t: jt.transformer_forward_with_aux(p, t, config)[1])
    opt_state = optimizer.init(params)
    losses, auxes = [], []
    for tokens in batches:
        tokens = jnp.asarray(tokens)
        auxes.append(float(aux_of(params, tokens)))
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses, auxes


def _torch_run(model, batches, lr):
    step = tt.transformer_train_step(model, tt.adamw(model, lr))
    losses, auxes = [], []
    for tokens in batches:
        tokens = torch.from_numpy(tokens)
        with torch.no_grad():
            auxes.append(float(tt.transformer_forward_with_aux(model, tokens)[1]))
        losses.append(float(step(tokens)))
    return losses, auxes


def _first_parting(want, got, rtol):
    for i, (a, b) in enumerate(zip(want, got)):
        if abs(a - b) > rtol * abs(a):
            return i
    return None


@pytest.mark.parametrize('lr', [1e-3, 1e-2], ids=['pretrain-lr', 'example-lr'])
def test_moe_training_matches_jax_step_for_step(lr):
    jax_config = jt.TransformerConfig(dtype=jnp.float32, **LM)
    torch_config = tt.TransformerConfig(dtype=torch.float32, **LM)
    params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
    model = tt.Transformer(torch_config)
    model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    batches = _batches()
    want_loss, want_aux = _jax_run(params, jax_config, batches, lr)
    got_loss, got_aux = _torch_run(model, batches, lr)
    assert len(got_loss) == len(want_loss) == STEPS
    assert _first_parting(want_loss, got_loss, 1e-3) is None, (want_loss, got_loss)
    assert _first_parting(want_aux, got_aux, 1e-3) is None, (want_aux, got_aux)
    # each block's Switch loss is at least 1: the sum over 2 blocks
    assert min(got_aux) >= 2.0 - 1e-5
