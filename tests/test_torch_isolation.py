"""apex_tpu_torch stands alone: no JAX, nothing of apex_tpu.

The machine with the GPU has no JAX, so every module of the port,
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` must import without
it. The check runs in a fresh
interpreter where importing ``jax`` fails outright.
"""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import apex_tpu_torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import apex_tpu_torch
names = ["apex_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(apex_tpu_torch.__path__,
                                          "apex_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (imported, main() not run)
sys.path.insert(0, "tests")
import test_torch_cuda  # noqa: F401  (the tests run on the card, no JAX)
loaded = sorted(m for m in sys.modules
                if m == "apex_tpu" or m.startswith("apex_tpu.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
print(json.dumps({"modules": names, "leaked": loaded}))
"""


def test_port_imports_without_jax_or_apex_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [], res["leaked"]
    expected = {m.name for m in pkgutil.walk_packages(
        apex_tpu_torch.__path__, "apex_tpu_torch.")}
    assert expected <= set(res["modules"])
    assert "apex_tpu_torch.serving.engine" in res["modules"]
    for name in ("ops.fused_block", "ops.multi_tensor",
                 "transformer.functional.fused_softmax",
                 "transformer.testing.standalone_bert",
                 "optimizers.fused_lamb", "optimizers.fused_sgd",
                 "optimizers.fused_novograd", "optimizers.fused_adagrad",
                 "amp.scaler", "contrib.clip_grad.clip_grad",
                 "ops.packed_optimizer", "telemetry.recorder",
                 "telemetry.metrics", "telemetry.numerics",
                 "normalization.fused_layer_norm",
                 "transformer.layers.layer_norm",
                 "contrib.layer_norm.layer_norm",
                 "resilience.watchdog", "resilience.chaos",
                 "resilience.retry", "serving.spec_decode",
                 "serving.robustness", "telemetry.spans",
                 "contrib.fmha.fmha", "contrib.multihead_attn.multihead_attn",
                 "contrib.openfold.mha", "contrib.openfold.layer_norm",
                 "amp.amp", "amp.utils", "amp.handle", "amp.frontend",
                 "amp.lists.torch_overrides", "fp16_utils.fp16util",
                 "fp16_utils.loss_scaler", "fp16_utils.fp16_optimizer",
                 "examples.imagenet.resnet", "examples.imagenet.main_amp",
                 "fused_dense.fp8", "fused_dense.fused_dense", "mlp.mlp",
                 "transformer.functional.fused_rope",
                 "contrib.openfold.fused_adam_swa",
                 "contrib.index_mul_2d.index_mul_2d",
                 "contrib.focal_loss.focal_loss",
                 "contrib.group_norm.group_norm", "parallel.sync_batchnorm",
                 "contrib.groupbn.batch_norm", "contrib.cudnn_gbn",
                 "contrib.conv_bias_relu.conv_bias_relu",
                 "contrib.bottleneck.bottleneck",
                 "contrib.sparsity.sparse_masklib", "contrib.sparsity.asp",
                 "contrib.sparsity.permutation_search",
                 "contrib.optimizers.legacy", "contrib.optimizers",
                 "contrib.transducer.transducer", "RNN.cells",
                 "RNN.models", "multi_tensor_apply.multi_tensor_apply",
                 "optimizers._common", "ops.hostio",
                 "contrib.gpu_direct_storage",
                 "contrib.gpu_direct_storage.gds", "checkpoint",
                 "transformer.testing.standalone_gpt",
                 "examples.gpt.gpt_scaling_test",
                 "transformer.parallel_state", "parallel.multiproc",
                 "transformer.amp", "transformer.amp.grad_scaler"):
        assert "apex_tpu_torch." + name in res["modules"], name


def test_port_sources_name_no_jax():
    """No source line of the port imports jax or apex_tpu."""
    files = list((REPO / "apex_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "apex_tpu"
                            or mod.startswith("apex_tpu.")), (f, line)


def test_engine_defaults_to_the_card():
    """``device=None`` means CUDA: on a host without one it raises
    instead of quietly serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from apex_tpu_torch.serving import ServingEngine
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    cfg = GPTConfig(num_layers=1, hidden_size=64, num_attention_heads=4,
                    vocab_size=64, max_position_embeddings=16)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    ServingEngine(cfg, params, device="cpu")  # the explicit CPU path


def test_amp_and_the_resnet_example_default_to_the_card():
    """``amp.initialize`` over a tree with no tensor puts its scaler
    states on the card, and the example's ``--device`` default is the
    card: on a host without one both raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet import main_amp

    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.initialize({}, None, opt_level="O2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_amp.main(main_amp.parse(["--synthetic", "--arch", "resnet18"]))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no
    result line; alone in a directory it cannot even import."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and '"ok"' not in out.stdout
