"""Port parity of the training half (`repro_torch.train`,
`repro_torch.models` in train mode, `ops.FlashAttentionFn`) against the JAX
reference (`repro.train`) on the CPU, at SMOKE size in float32.

  - `loss_fn` and its gradients against `jax.value_and_grad(loss_fn)` for
    seven architectures (dense, MoE, MLA + MTP, SSD, the hybrid, M-RoPE
    with a vision prefix, the audio encoder) on the dense attention path
    (tests/test_torch_train_flash.py forces the flash path); the
    gradients must be finite;
  - AdamW, Adafactor, the global norm and the clip fed the same numpy
    gradients in both packages;
  - accumulation over microbatches against one batch; `SyntheticDataset`
    bit-equal to the reference's; the launcher on the CPU;
  - train mode reaches every attention weight through the flash path.
Tolerances: the loss to 1e-5 relative; each leaf's gradient within
1e-4 x the largest |g| of that leaf (float32 sums in other orders, and the
flash path's chunked softmax); optimizer updates to 1e-6 (the same float32
arithmetic, pow and sqrt from two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.shapes import ShapeSpec as JShape
from repro.models import init_params as j_init_params
from repro.train import loss_fn as j_loss_fn
from repro.train import optimizer as j_opt
from repro.train.data import SyntheticDataset as JData
from repro_torch import convert
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs import ShapeSpec as TShape
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import forward as t_forward
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train import optimizer as t_opt
from repro_torch.train.data import SyntheticDataset as TData
from repro_torch.train.data import to_device

ARCHS = ["qwen1.5-0.5b", "mixtral-8x22b", "deepseek-v3-671b", "mamba2-130m",
         "jamba-1.5-large-398b", "qwen2-vl-7b", "hubert-xlarge"]
LOSS_RTOL, GRAD_TOL, OPT_TOL = 1e-5, 1e-4, 1e-6
SEQ, BATCH = 48, 2
FLASH = {"flash_threshold": 32, "flash_chunk": 16}


def _perturb_norms(tree, rng):
    for key, node in tree.items():
        if isinstance(node, dict):
            _perturb_norms(node, rng)
        elif "norm" in key:
            tree[key] = 1.0 + 0.1 * rng.normal(size=node.shape)


def _pair(arch, flash, seed=0):
    """(reference cfg, its params, port cfg, port model in train mode) in
    float32 on the reference's init, norm weights perturbed in numpy."""
    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", **(FLASH if flash else {}))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    _perturb_norms(np_params, np.random.default_rng(seed))
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = convert.lm_params_from_numpy(np_params, tcfg, device="cpu").train_mode()
    return jcfg, jparams, tcfg, model


def _batch(jcfg, seed=1):
    return JData(jcfg, JShape("train", SEQ, BATCH, "train"), seed=seed).batch(0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def check_loss_and_grads(arch, flash):
    """loss_fn's total, ce and aux, and each leaf's gradient, against
    jax.value_and_grad of the reference's loss_fn on the same weights and
    batch; every gradient finite."""
    jcfg, jparams, tcfg, model = _pair(arch, flash)
    batch = _batch(jcfg)
    (jtotal, (jce, jaux)), jgrads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                                            static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    ops.reset_launches()
    step = make_train_step(tcfg, OptConfig(name=tcfg.optimizer))
    total, ce, aux, grads = step.compute_grads(model, to_device(batch, tcfg, "cpu"))
    assert float(total) == pytest.approx(float(jtotal), rel=LOSS_RTOL)
    assert float(ce) == pytest.approx(float(jce), rel=LOSS_RTOL)
    assert float(aux) == pytest.approx(float(jaux), rel=LOSS_RTOL, abs=1e-7)
    got = _flat(convert.lm_params_to_numpy(model, tcfg, grads))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale, f"{name}: max err {err} > {GRAD_TOL} x {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    """The dense attention path (T below flash_threshold)."""
    check_loss_and_grads(arch, flash=False)


def test_flash_forced_training_reaches_every_attention_weight():
    """With the flash path taken, train mode gives wq / wk / wv and the QKV
    biases of every layer a finite, nonzero gradient (the kernel's output
    would carry no grad_fn outside FlashAttentionFn)."""
    jcfg, _, tcfg, model = _pair("qwen1.5-0.5b", flash=True)
    batch = to_device(_batch(jcfg), tcfg, "cpu")
    out = t_forward(model, tcfg, tokens=batch["tokens"], train=True)
    assert out.logits.grad_fn is not None
    out.logits.float().square().mean().backward()
    for i, layer in enumerate(model.layers):
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            g = getattr(layer.mixer, name).grad
            assert g is not None and torch.isfinite(g).all(), (i, name)
            assert float(g.abs().max()) > 0, (i, name)


def test_flash_attention_fn_gradient_matches_autograd_of_the_plain_version():
    """FlashAttentionFn's backward (chunked, checkpointed recompute) against
    autograd through the unchunked plain version, with a window, an offset
    and written_upto, so chunks are fully masked for some rows."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((2, 40, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    kw = dict(causal=True, window=20, q_offset=10, written_upto=60)
    g_out = torch.from_numpy(rng.normal(size=(2, 40, 4, 16)).astype(np.float32))
    out = ops.FlashAttentionFn.apply(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                                     kw["written_upto"], 16)
    got = torch.autograd.grad(out, (q, k, v), g_out)
    want_out = ops.ref.flash_attention_ref(q, k, v, chunk=64, **kw)
    want = torch.autograd.grad(want_out, (q, k, v), g_out)
    np.testing.assert_allclose(out.detach(), want_out.detach(), rtol=1e-5, atol=1e-6)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (7,), "stack": (3, 4, 5), "s": (1,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_the_reference(name, steps):
    cfg = OptConfig(name=name, lr=1e-2)
    jcfg = j_opt.OptConfig(name=name, lr=1e-2)
    params = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    groups = t_opt.flat_groups(tp)
    js, ts = j_opt.init_opt(name, jp), t_opt.init_opt(name, tp, groups)
    for i in range(steps):
        grads = _opt_tree(10 + i)
        jp, js = j_opt.apply_opt(name, {k: jnp.asarray(v) for k, v in grads.items()},
                                 js, jp, jcfg)
        tp, ts = t_opt.apply_opt(name, {k: torch.from_numpy(v) for k, v in grads.items()},
                                 ts, tp, cfg, groups)
    assert int(ts["count"]) == int(js["count"]) == steps
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=OPT_TOL,
                                   atol=OPT_TOL)
    if name == "adamw":
        for part in ("m", "v", "master"):
            for k in params:
                np.testing.assert_allclose(ts[part][k].numpy(), np.asarray(js[part][k]),
                                           rtol=OPT_TOL, atol=1e-9)
    else:
        for k in params:
            for part, arr in js["v"][k].items():
                np.testing.assert_allclose(ts["v"][k][part].numpy(), np.asarray(arr),
                                           rtol=OPT_TOL, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_global_norm_match_the_reference(max_norm):
    grads = _opt_tree(4)
    jg, jn = j_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()},
                                       max_norm)
    tg, tn = t_opt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in grads.items()},
                                       max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=OPT_TOL)
    assert float(t_opt.global_norm(tg)) == pytest.approx(min(max_norm, float(jn)), rel=1e-5)
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=OPT_TOL,
                                   atol=1e-7)


# --------------------------------------------------------------------------
# accumulation, data, launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-7b"])
def test_grad_accum_matches_single_batch(arch):
    """Two microbatches (positions3 split on its axis 1) give the one-batch
    step's loss and parameters: the reference's test, in float32 here."""
    cfg = dataclasses.replace(T_SMOKE[arch], dtype="float32")
    batch = to_device(TData(cfg, TShape("train", 16, 4, "train"), seed=3).batch(0), cfg,
                      "cpu")
    out = []
    for accum in (1, 2):
        model, opt_state = init_train_state(cfg, seed=3, device="cpu")
        step = make_train_step(cfg, OptConfig(name=cfg.optimizer, lr=1e-3), accum=accum)
        _, _, m = step(model, opt_state, batch, 0)
        out.append((float(m.loss), {n: p.detach().clone()
                                    for n, p in model.named_parameters()}))
    (l1, p1), (l2, p2) = out
    assert l1 == pytest.approx(l2, rel=1e-5)
    worst = max(float((p1[n] - p2[n]).abs().max()) for n in p1)
    assert worst < 1e-5


@pytest.mark.parametrize("arch,process_count", [
    ("qwen1.5-0.5b", 1), ("qwen2-vl-7b", 1), ("hubert-xlarge", 1), ("qwen1.5-0.5b", 2)])
def test_synthetic_dataset_is_bit_equal_to_the_reference(arch, process_count):
    jd = JData(J_SMOKE[arch], JShape("train", 32, 4, "train"), seed=5,
               process_index=process_count - 1, process_count=process_count)
    td = TData(T_SMOKE[arch], TShape("train", 32, 4, "train"), seed=5,
               process_index=process_count - 1, process_count=process_count)
    for step in (0, 7):
        want, got = jd.batch(step), td.batch(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("ckpt", [False, True])
def test_launcher_trains_on_the_cpu(tmp_path, ckpt):
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq-len", "32", "--log-every", "1"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    fig = launch_train.main(argv)
    assert len(fig["losses"]) == 3 and np.isfinite(fig["losses"]).all()
    assert fig["attn_grads"] and all(v > 0 for v in fig["attn_grads"].values())
    if ckpt:
        from repro_torch.train import checkpoint
        assert checkpoint.all_steps(str(tmp_path)) == [2, 3]
        assert fig["restarts"] == 0
        again = launch_train.main(argv[:argv.index("--steps") + 1] + ["4"]
                                  + argv[argv.index("--steps") + 2:])
        # resumed from step 3: one step more
        assert len(again["losses"]) == 1


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """No quiet CPU run: the launcher and init_train_state take the card
    unless asked for the CPU, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T_SMOKE["qwen1.5-0.5b"]
    for call in (lambda: init_train_state(cfg),
                 lambda: launch_train.main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
