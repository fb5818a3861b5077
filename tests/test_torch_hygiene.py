"""Rules of the PyTorch port that no parity test would catch: it imports
nothing of JAX or of the JAX package, it never runs on the CPU unless asked,
and it builds no kernel when imported."""
import ast
import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the port's package, its smoke script and its own scripts under tools/
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_reference():
    assert len(PORT_FILES) > 15
    bad = [(p.relative_to(ROOT).as_posix(), name)
           for p in PORT_FILES for name in _imports(p)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _cpu_model():
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_reduced_config("minitron_4b"),
                              param_dtype="float32", activ_dtype="float32")
    return cfg, Model(cfg, device="cpu")


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    cfg, model = _cpu_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, {})
    ServingEngine(model, device="cpu")          # named explicitly: fine


def test_training_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.bridge import opt_state_from_numpy
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import train_lm
    from repro_torch.models import Model
    cfg, model = _cpu_model()
    whisper = get_reduced_config("whisper_large_v3")
    for make in (lambda: Model(whisper), lambda: Model(cfg, remat_policy="dots"),
                 lambda: SyntheticLM(256, 8, 2),
                 lambda: make_batch(cfg, ShapeCell("t", "train", 8, 2)),
                 lambda: load_checkpoint(tmp_path, {"w": torch.zeros(2)}),
                 lambda: opt_state_from_numpy(cfg, {}),
                 lambda: train_lm.main(["--steps", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # named explicitly: fine
    batch = SyntheticLM(cfg.vocab_size, 8, 2, device="cpu").batch_at(0)
    loss, _ = model.train_loss(batch)
    assert loss.device.type == "cpu"
    save_checkpoint(tmp_path, 1, {"w": torch.ones(2)})
    assert load_checkpoint(tmp_path, {"w": torch.zeros(2)}, device="cpu")[1]["w"].sum() == 2


def test_importing_the_port_builds_no_kernel():
    for mod in ("repro_torch.kernels.ops", "repro_torch.serving.engine",
                "repro_torch.bridge", "repro_torch.models.ssm", "repro_torch.models.encdec",
                "repro_torch.launch.steps", "repro_torch.launch.train_lm",
                "repro_torch.runtime", "repro_torch.checkpoint", "repro_torch.data"):
        importlib.import_module(mod)
    from repro_torch.kernels import _build
    assert _build._LIB is None


def test_unported_architectures_raise_key_error():
    from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_reduced_config
    for arch in ARCH_IDS:
        if arch in PORTED:
            assert get_config(arch).name and get_reduced_config(arch).num_layers
        else:
            with pytest.raises(KeyError, match="not ported"):
                get_config(arch)
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-17")
