"""petastorm_tpu_torch Switch-MoE layer and MoE transformer against the JAX
package's, on the CPU.

Weights carry across from ``init_moe_params``/``init_transformer_params``
(f32); activations and tokens are made with numpy from a seed. Sizes: 4
experts, d_model 16, d_ff 32, 32 tokens (``tests/test_moe.py``'s), and a
2-layer transformer with vocab 32. Tolerances: f32 ``y`` atol 1e-5, the
aux loss 1e-6 and the transformer loss 1e-5 (both sides compute in f32;
sums run in another order); gradients 1e-4; the bf16 expert compute
within 5e-2 of f32, as ``tests/test_moe.py`` holds the JAX layer.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.models import moe as jm
from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.models import moe as tm
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

D, F, E = 16, 32, 4


def _configs(dtype='f32', capacity_factor=1.25, n_experts=E):
    jax_dtype, torch_dtype = ((jnp.float32, torch.float32) if dtype == 'f32'
                              else (jnp.bfloat16, torch.bfloat16))
    return (jm.MoEConfig(d_model=D, d_ff=F, n_experts=n_experts,
                         capacity_factor=capacity_factor, dtype=jax_dtype),
            tm.MoEConfig(d_model=D, d_ff=F, n_experts=n_experts,
                         capacity_factor=capacity_factor, dtype=torch_dtype))


def _setup(seed=0, n_experts=E):
    jax_config, torch_config = _configs(n_experts=n_experts)
    params = jm.init_moe_params(jax.random.PRNGKey(seed), jax_config)
    layer = tm.MoE(torch_config)
    layer.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    x = np.random.RandomState(seed + 1).randn(4, 8, D).astype(np.float32)
    return jax_config, torch_config, params, layer, x


@pytest.fixture(scope='module')
def setup():
    return _setup()


@pytest.mark.parametrize('capacity', [32, None, 2, 1], ids=['ample', 'default', 'tight', 'one'])
def test_layer_matches_jax(setup, capacity):
    jax_config, torch_config, params, layer, x = setup
    y_want, aux_want = jm.moe_forward(params, jnp.asarray(x), jax_config, capacity=capacity)
    with torch.no_grad():
        y, aux = tm.moe_forward(layer, torch.from_numpy(x), torch_config, capacity=capacity)
    assert y.shape == x.shape and y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6, rtol=0)


@pytest.mark.parametrize('n_experts', [2, 8])
def test_layer_matches_jax_at_other_expert_counts(n_experts):
    jax_config, torch_config, params, layer, x = _setup(seed=3, n_experts=n_experts)
    y_want, aux_want = jm.moe_forward(params, jnp.asarray(x), jax_config)
    with torch.no_grad():
        y, aux = tm.moe_forward(layer, torch.from_numpy(x), torch_config)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6, rtol=0)


def test_matches_dense_oracle_with_ample_capacity(setup):
    jax_config, torch_config, params, layer, x = setup
    with torch.no_grad():
        y, _ = tm.moe_forward(layer, torch.from_numpy(x), torch_config, capacity=32)
    want = tm.dense_oracle(layer, x, torch_config)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(want, jm.dense_oracle(params, jnp.asarray(x), jax_config),
                               atol=1e-6, rtol=1e-6)


def test_capacity_drop_passes_tokens_through_as_zero(setup):
    _, torch_config, _, layer, x = setup
    with torch.no_grad():
        y, _ = tm.moe_forward(layer, torch.from_numpy(x), torch_config, capacity=1)
    got = y.numpy().reshape(-1, D)
    want = tm.dense_oracle(layer, x, torch_config).reshape(-1, D)
    dropped = ~np.abs(got).sum(axis=1).astype(bool)
    assert dropped.sum() >= 32 - E and (~dropped).any()
    np.testing.assert_allclose(got[~dropped], want[~dropped], atol=1e-5, rtol=1e-5)


def _with_router(layer, router):
    other = copy.deepcopy(layer)
    with torch.no_grad():
        other.router.copy_(router)
    return other


def test_aux_loss_uniform_routing_is_one(setup):
    _, torch_config, _, layer, x = setup
    with torch.no_grad():
        _, aux = tm.moe_forward(_with_router(layer, torch.zeros(D, E)), torch.from_numpy(x),
                                torch_config)
    # uniform probabilities, every argmax tie to expert 0: E * (1 * 1/E)
    assert abs(float(aux) - 1.0) <= 1e-6


def test_aux_loss_penalizes_collapse(setup):
    _, torch_config, _, layer, x = setup
    router = torch.zeros(D, E)
    router[:, 0] = 10.0 / D
    x_pos = torch.from_numpy(np.abs(x) + 0.1)
    with torch.no_grad():
        _, collapsed = tm.moe_forward(_with_router(layer, router), x_pos, torch_config)
        _, uniform = tm.moe_forward(_with_router(layer, torch.zeros(D, E)), x_pos,
                                    torch_config)
    assert float(collapsed) > float(uniform)


@pytest.mark.parametrize('n_tokens', [1, 3, 7, 32, 100, 8192, 2 ** 24 + 1])
@pytest.mark.parametrize('n_experts,factor', [(4, 1.0), (4, 1.25), (8, 2.0), (3, 1.1)])
def test_expert_capacity_matches_jax(n_tokens, n_experts, factor):
    assert (tm.expert_capacity(n_tokens, n_experts, factor)
            == jm.expert_capacity(n_tokens, n_experts, factor))


def test_expert_capacity_values():
    assert tm.expert_capacity(32, 4, 1.0) == 8
    assert tm.expert_capacity(32, 4, 1.25) == 10
    assert tm.expert_capacity(3, 4, 1.0) == 1
    assert tm.expert_capacity(8192, 4, 1.25) == 2560     # the MoE flagship's capacity


def test_bfloat16_expert_compute_stays_close(setup):
    jax_config, torch_config, params, layer, x = setup
    _, bf16 = _configs('bf16')
    with torch.no_grad():
        y32, _ = tm.moe_forward(layer, torch.from_numpy(x), torch_config)
        y16, _ = tm.moe_forward(layer, torch.from_numpy(x), bf16)
        y16_in, _ = tm.moe_forward(layer, torch.from_numpy(x).to(torch.bfloat16), bf16)
    assert y16.dtype == torch.float32 and y16_in.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), atol=5e-2, rtol=5e-2)
    jax_bf16 = jm.MoEConfig(d_model=D, d_ff=F, n_experts=E, dtype=jnp.bfloat16)
    want, _ = jm.moe_forward(params, jnp.asarray(x), jax_bf16)
    np.testing.assert_allclose(y16.numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=5e-2)


def test_grads_match_jax(setup):
    jax_config, torch_config, params, layer, x = setup

    def loss(p, a):
        y, aux = jm.moe_forward(p, a, jax_config)
        return jnp.sum(y) + aux

    want, want_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    layer.zero_grad()
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tm.moe_forward(layer, xt, torch_config)
    (y.sum() + aux).backward()
    for name in ('router', 'w_in', 'w_out'):
        grad = getattr(layer, name).grad
        assert grad.abs().sum() > 0, name
        np.testing.assert_allclose(grad.numpy(), np.asarray(want[name]), atol=1e-4, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-4, rtol=0)


def test_seq_axis_is_item_8(setup):
    """``moe_forward(seq_axis=)`` (item 8 until expert parallelism was
    ported) needs a mesh to find the dim's ranks; on a dim of one shard it
    routes and sums exactly as the unsplit layer, and as the JAX layer."""
    jax_config, torch_config, params, layer, x = setup

    class SeqMesh:
        mesh_dim_names = ('seq',)

        def get_coordinate(self):
            return [0]

        def size(self, dim):
            return 1

        def get_group(self, name):
            return None

        def get_local_rank(self, name):
            return 0

    with pytest.raises(ValueError, match='needs the mesh'):
        tm.moe_forward(layer, torch.from_numpy(x), torch_config, seq_axis='seq')
    with torch.no_grad():
        y, aux = tm.moe_forward(layer, torch.from_numpy(x), torch_config, seq_axis='seq',
                                mesh=SeqMesh())
    y_want, aux_want = jm.moe_forward(params, jnp.asarray(x), jax_config)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6, rtol=0)


def test_init_scales():
    layer = tm.init_moe(0, tm.MoEConfig(d_model=64, d_ff=256, n_experts=4), device='cpu')
    for p, scale in ((layer.router, 64 ** -0.5), (layer.w_in, 64 ** -0.5),
                     (layer.w_out, 256 ** -0.5)):
        assert p.dtype == torch.float32 and abs(p.detach().std().item() - scale) < 0.1 * scale
    again = tm.init_moe(0, tm.MoEConfig(d_model=64, d_ff=256, n_experts=4), device='cpu')
    assert torch.equal(layer.w_out, again.w_out)


# -- the MoE transformer -------------------------------------------------------------

LM = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=24,
          n_experts=4)


def _lm(**kw):
    jax_config = jt.TransformerConfig(dtype=jnp.float32, **LM, **kw)
    torch_config = tt.TransformerConfig(dtype=torch.float32, **LM, **kw)
    params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
    model = tt.Transformer(torch_config)
    model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_config, params, model


def _tokens(b=2, s=17, seed=3):
    return np.random.RandomState(seed).randint(0, 32, (b, s)).astype(np.int32)


@pytest.mark.parametrize('remat', [False, True])
@pytest.mark.parametrize('loss_chunk', [0, 8])
def test_moe_transformer_loss_matches_jax(remat, loss_chunk):
    jax_config, params, model = _lm(remat=remat, loss_chunk=loss_chunk)
    tokens = _tokens()
    want = float(jt.transformer_loss(params, jnp.asarray(tokens), jax_config))
    loss = tt.transformer_loss(model, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - want) <= 1e-5
    router_grad = model.blocks[0].moe.router.grad
    assert router_grad is not None and router_grad.abs().sum() > 0


def test_moe_transformer_aux_and_logits_match_jax():
    jax_config, params, model = _lm()
    tokens = _tokens(s=12)
    logits_want, aux_want = jt.transformer_forward_with_aux(params, jnp.asarray(tokens),
                                                            jax_config)
    with torch.no_grad():
        logits, aux = tt.transformer_forward_with_aux(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_want), atol=2e-5, rtol=2e-5)
    # the sum over both blocks' Switch losses, each >= 1
    assert float(aux) >= 2.0 - 1e-5
    np.testing.assert_allclose(float(aux), float(aux_want), atol=1e-6, rtol=0)


def test_moe_transformer_grads_match_jax():
    jax_config, params, model = _lm(remat=True)
    tokens = _tokens(seed=4)
    want = jax.grad(jt.transformer_loss)(params, jnp.asarray(tokens), jax_config)
    tt.transformer_loss(model, torch.from_numpy(tokens)).backward()
    got = dict(model.named_parameters())
    for name, value in tt.params_from_jax(jax.tree_util.tree_map(np.asarray, want)).items():
        np.testing.assert_allclose(got[name].grad.numpy(), value.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_moe_block_tree_matches_jax():
    _, params, model = _lm()
    assert set(params['blocks'][0]) == {'qkv', 'attn_out', 'ln1', 'ln2', 'moe'}
    names = set(model.state_dict())
    assert {'blocks.1.moe.router', 'blocks.1.moe.w_in', 'blocks.1.moe.w_out'} <= names
    assert not any('mlp' in n for n in names)
    assert model.blocks[0].moe.w_in.shape == (4, 16, 32)
    fresh = tt.init_transformer(0, model.config, device='cpu')
    assert fresh.blocks[0].moe.router.shape == (16, 4)
    assert abs(fresh.blocks[0].moe.w_out.detach().std().item() - 32 ** -0.5) < 0.05


def test_moe_transformer_trains():
    model = tt.init_transformer(0, tt.TransformerConfig(dtype=torch.float32, **LM),
                                device='cpu')
    step = tt.transformer_train_step(model, tt.adamw(model, 1e-2), accum_steps=2)
    tokens = torch.from_numpy(_tokens(b=4))
    losses = [float(step(tokens)) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_masked_loss_refuses_moe():
    _, _, model = _lm()
    tokens = torch.from_numpy(_tokens())
    with pytest.raises(NotImplementedError, match='dense configs only'):
        tt.transformer_masked_loss(model, tokens, torch.tensor([17, 9]))
