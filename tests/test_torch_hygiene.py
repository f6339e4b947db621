"""The port stands alone: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` (or ``jaxlib``) or anything of the
reference package ``repro`` — also not its JAX-free modules — and
importing the port starts no kernel build."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = [(m, line) for m, line in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys; import repro_torch.api, repro_torch.serve, "
            "repro_torch.kernels.conv3d.ops, repro_torch.kernels.bn_act.ops, "
            "repro_torch.kernels.halo_pack.ops, repro_torch.core.spmd, "
            "repro_torch.core.reshard, repro_torch.launch.mesh, "
            "repro_torch.train.train_step; "
            "from repro_torch.kernels import _build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; assert not _build._LIBS")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_failed_kernel_build_raises(tmp_path, monkeypatch):
    """No nvcc (as on a CPU-only host) is a build error, never a silent
    fallback; nothing half-built is left for a later load."""
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build_all()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
