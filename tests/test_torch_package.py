"""Package-level checks of the port: it imports without JAX, its config
schema is the JAX package's, every shared experiment YAML loads into both,
and what is not ported yet says so."""
import ast
import dataclasses
import glob
import pathlib
import subprocess
import sys

import pytest
import torch

import localregneuralde_tpu.harness.config as jax_config
import localregneuralde_tpu_torch
import localregneuralde_tpu_torch.harness.config as torch_config
from localregneuralde_tpu_torch.harness import construct_model
from localregneuralde_tpu_torch.models import NeuralODE, TDChain
from localregneuralde_tpu_torch.nn import Dense

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(localregneuralde_tpu_torch.__file__).parent


def test_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import localregneuralde_tpu_torch, localregneuralde_tpu_torch.harness\n"
        "import localregneuralde_tpu_torch.ops.cuda, localregneuralde_tpu_torch.parity\n"
        "import localregneuralde_tpu_torch.harness.latent_runner\n"
        "import localregneuralde_tpu_torch.harness.runner\n"
        "import localregneuralde_tpu_torch.ops.cuda.fused_conv_bwd\n"
        "import localregneuralde_tpu_torch.harness.checkpoint\n"
        "import localregneuralde_tpu_torch.harness.logging\n"
        "import localregneuralde_tpu_torch.models.latent_ode\n"
        "import localregneuralde_tpu_torch.nn.recurrence\n"
        "import localregneuralde_tpu_torch.utils\n"
        "import localregneuralde_tpu_torch.utils.export\n"
        "import localregneuralde_tpu_torch.utils.profiling\n"
        "import localregneuralde_tpu_torch.ops.cuda.serving\n"
        "import localregneuralde_tpu_torch.native, localregneuralde_tpu_torch.native.loader\n"
        "import localregneuralde_tpu_torch.parallel\n"
        "from localregneuralde_tpu_torch.parallel import (mesh, multihost,\n"
        "    sharded_train, shardmap_train)\n"
        "from localregneuralde_tpu_torch.utils import (PhaseTimer, trace,\n"
        "    export_fn, export_model, export_model_multi, save_exported,\n"
        "    load_exported)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_latent_runner_entry_point_runs_without_jax(tmp_path):
    """``python -m localregneuralde_tpu_torch.harness.latent_runner`` with
    JAX made unimportable: one small step on the CPU, to its summary."""
    code = (
        "import runpy, sys; sys.modules['jax'] = None\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_module('localregneuralde_tpu_torch.harness.latent_runner',"
        " run_name='__main__')\n"
    )
    args = [
        "latent_runner", "experiments/physionet/physionet.yaml",
        "--device=cpu", "--model.ts_in_dims=3", "--model.ts_hidden_dims=4",
        "--model.ts_latent_dims=3", "--model.ts_node_dims=2",
        "--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
        "--model.solver.max_steps=32", "--dataset.train_batchsize=4",
        "--dataset.eval_batchsize=410", "--train.total_steps=1",
        f"--train.checkpoint_dir={tmp_path}/ckpt",
        f"--train.log_dir={tmp_path}/logs",
    ]
    out = subprocess.run(
        [sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "summary:" in out.stdout and "masked_mse" in out.stdout


def test_classification_runner_entry_point_runs_without_jax(tmp_path):
    """``python -m localregneuralde_tpu_torch.harness.runner`` with JAX made
    unimportable: one small MNIST Neural ODE step on the CPU, its eval and
    checkpoint, to its summary."""
    code = (
        "import runpy, sys; sys.modules['jax'] = None\n"
        "sys.argv = sys.argv[1:]\n"
        "runpy.run_module('localregneuralde_tpu_torch.harness.runner',"
        " run_name='__main__')\n"
    )
    args = [
        "runner", "experiments/mnist_ode/mlp.yaml", "--device=cpu",
        "--model.mlp_hidden_state_size=8", "--model.solver.reltol=1e-2",
        "--model.solver.abstol=1e-2", "--model.solver.max_steps=32",
        "--dataset.train_batchsize=8", "--dataset.eval_batchsize=1024",
        "--train.total_steps=1", f"--train.checkpoint_dir={tmp_path}/ckpt",
        f"--train.log_dir={tmp_path}/logs",
    ]
    out = subprocess.run(
        [sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "summary:" in out.stdout and "accuracy_top1" in out.stdout
    assert (tmp_path / "ckpt").exists()


def test_no_module_imports_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert not any(
                n == "jax" or n.startswith(("jax.", "localregneuralde_tpu."))
                or n == "localregneuralde_tpu" for n in names
            ), f"{path} imports {names}"


def test_no_module_loads_the_jax_packages_native_library():
    """Neither the port nor ``chip_smoke.py`` names the JAX package's
    native library or imports its module: the port builds and loads its
    own (``libnativeloader_<hash>.so`` under ``build/``)."""
    files = list(PKG.rglob("*.py")) + list(PKG.rglob("*.cpp")) + [
        ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert "libnativeloader.so" not in text, path
        assert "localregneuralde_tpu.native" not in text, path


def test_chip_smoke_imports_no_jax():
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        assert not any(
            n == "jax" or n.startswith(("jax.", "localregneuralde_tpu."))
            or n == "localregneuralde_tpu" for n in names), names


def test_native_loader_builds_under_build_not_beside_its_source():
    """The loader's library goes to ``build/`` at the repository root under
    a name hashed from its source, never into the package."""
    from localregneuralde_tpu_torch.native import loader

    lib = loader.build()
    assert lib.parent == ROOT / "build" and lib.exists()
    assert lib.name.startswith("libnativeloader_")
    assert not list((PKG / "native").glob("*.so"))


def _schema(module):
    def default(f):
        v = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    def fields(cls):
        return [(f.name, str(f.type), default(f))
                for f in dataclasses.fields(cls)]

    return {
        name: fields(getattr(module, name))
        for name in dir(module)
        if dataclasses.is_dataclass(getattr(module, name))
    }


def test_config_schema_matches_jax():
    ours, ref = _schema(torch_config), _schema(jax_config)
    assert ours.keys() == ref.keys() and "ExperimentConfig" in ours
    for name in ref:
        assert ours[name] == ref[name], name


@pytest.mark.parametrize(
    "path", sorted(glob.glob(str(ROOT / "experiments" / "*" / "*.yaml")))
)
def test_experiment_yaml_loads_into_both(path):
    args = ["--model.solver.reltol=1e-4", "--train.total_steps=5"]
    ours = torch_config.define_configuration(args, path)
    ref = jax_config.define_configuration(args, path)
    assert torch_config.flatten_config(ours) == jax_config.flatten_config(ref)


def test_unported_paths_raise():
    """The solver modes and SDE solvers the port once lacked build and run
    from a config or the layers (vcab3, the direct adjoint, Milstein with
    and without sde_noise_dims, Euler–Heun, the score sampler's solvers);
    what is still unported (tensor parallelism) raises and cites its
    ROADMAP item; the global grid takes the SDE, conv and chain
    families."""
    cfg = torch_config.define_configuration(
        ["--model.solver.ode_solver=vcab3"], None
    )
    assert construct_model(cfg, device="cpu").neural_ode.solver == "vcab3"
    cifar = torch_config.define_configuration(
        ["--model.model_type=cifar10_cnn"], None
    )
    assert construct_model(cifar, device="cpu").neural_ode.family == "conv"
    node = NeuralODE(TDChain(Dense(5, 3, "tanh"), Dense(4, 4)),
                     adjoint="direct")
    sol, st = node(torch.zeros(2, 4), node.init_state(), training=True)
    assert sol.ys.shape == (1, 2, 4) and int(st["nfe"]) > 0
    for extra, want in ((["--model.sde_solver=milstein"], None),
                        (["--model.sde_solver=euler_heun"], None),
                        (["--model.sde_solver=milstein",
                          "--model.sde_noise_dims=2"], 2)):
        cfg = torch_config.define_configuration(extra, None)
        cfg.model.sde = True
        layer = construct_model(cfg, device="cpu").neural_dsde
        assert layer.solver == extra[0].split("=")[1]
        assert layer.noise_dims == want
    with pytest.raises(ValueError):
        NeuralODE(Dense(4, 4), use_pallas="on")
    from localregneuralde_tpu_torch.models import sample_vpsde

    for solver in ("milstein", "euler_heun"):
        s, sol = sample_vpsde(lambda u, t, p: -u, (4, 2), torch.Generator(),
                              solver=solver, rtol=0.5, atol=0.5,
                              device="cpu")
        assert s.shape == (4, 2) and int(sol.nfe_drift) > 0
    # tensor parallelism takes 'gspmd' only, as the JAX runner has it; the
    # global grid of data parallelism takes the SDE, conv and chain
    # families
    from localregneuralde_tpu_torch.harness.latent_runner import (
        check_supported,
    )
    from localregneuralde_tpu_torch.parallel.sharded_train import (
        check_global_grid,
    )

    tp = torch_config.define_configuration(
        ["--train.data_parallel=gspmd", "--train.tensor_parallel=2"], None)
    check_supported(tp)
    for mode in ("none", "shardmap"):
        tp = torch_config.define_configuration(
            [f"--train.data_parallel={mode}", "--train.tensor_parallel=2"],
            None)
        with pytest.raises(ValueError, match="requires data_parallel='gspmd'"):
            check_supported(tp)
    for extra, path in ((["--model.model_type=cifar10_cnn"], "neural_ode"),
                        ([], "neural_dsde")):
        cfg = torch_config.define_configuration(
            ["--train.data_parallel=gspmd"] + extra, None)
        cfg.model.sde = not extra
        model = construct_model(cfg, device="cpu")
        assert check_global_grid(model, model.init_state()) == [(path,)]
    from localregneuralde_tpu_torch.harness import construct_time_series

    latent = torch_config.define_configuration(
        ["--train.data_parallel=gspmd"], "experiments/physionet/physionet.yaml")
    model = construct_time_series(latent, saveat=torch.linspace(0, 1, 5),
                                  device="cpu")
    assert check_global_grid(model, model.init_state()) == [("neural_ode",)]


def test_kernel_dispatch():
    node = NeuralODE(TDChain(Dense(5, 3, "tanh"), Dense(4, 4)))
    x = torch.zeros(2, 4)
    assert node.use_pallas == "auto" and not node.uses_kernels(x)
    assert NeuralODE(TDChain(Dense(5, 3, "tanh"), Dense(4, 4)),
                     use_pallas=True).uses_kernels(x)
    # a dynamics the kernels do not cover never dispatches to them
    assert NeuralODE(Dense(4, 4)).use_pallas == "off"


def test_tf32_guard_below_rtol_1e4():
    """The solves refuse TF32 products below rtol 1e-4 on a CUDA device,
    whichever of PyTorch's two flags turned them on; the CPU and looser
    tolerances are not affected."""
    from localregneuralde_tpu_torch.nn import check_fp32_products

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            for g, v in zip(flags, saved):
                g.allow_tf32 = False
            f.allow_tf32 = True
            with pytest.raises(RuntimeError, match="allow_tf32"):
                check_fp32_products(1.4e-8, torch.device("cuda"))
            check_fp32_products(1e-4, "cuda")
            check_fp32_products(1.4e-8, "cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        check_fp32_products(1.4e-8, "cuda")
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="matmul.allow_tf32"):
            check_fp32_products(1e-5, "cuda")
    finally:
        torch.set_float32_matmul_precision("highest")
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
