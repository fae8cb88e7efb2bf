"""Installer / environment doctor for the PyTorch + CUDA stack.

The port of ``probgan_tpu/cli/install.py`` with the reference installer's
surface: ``--colab`` / ``--local`` / ``--check`` flags, exit codes 0/1 (no
flag -> usage + 1), and a doctor that probes imports, reports versions and
the accelerators.

The install targets run their steps as the reference's do
(``run_command``): each step runs in a shell, a failed step is reported and
the next one runs all the same, a summary closes the run, and the exit code
is 1 if any step failed. The steps are the port's own (PyTorch with CUDA,
NumPy; no JAX). Differences: the doctor reports torch, ``torch.version.cuda``,
``nvcc`` (the kernels in ``csrc/`` are built with it on first use) and the
CUDA cards from ``core/device.device_report()``.
"""

from __future__ import annotations

import argparse
import importlib
import shutil
import subprocess
import sys

from probgan_tpu_torch.core.device import device_report


def run_command(cmd: str, description: str = "") -> bool:
    """Run a shell command, print its outcome, return whether it succeeded."""
    print(f" {description}")
    print(f"   Running: {cmd}")
    try:
        subprocess.run(cmd, shell=True, check=True, capture_output=True, text=True)
        print("   Success")
        return True
    except subprocess.CalledProcessError as e:
        print(f"   Failed: {e}")
        print(f"   Error output: {e.stderr}")
        return False


_COLAB_STEPS = [
    (
        "pip install torch --index-url https://download.pytorch.org/whl/cu128",
        "Installing PyTorch with CUDA support",
    ),
    ("pip install numpy", "Installing NumPy"),
]
_LOCAL_STEPS = [
    ("pip install torch numpy", "Installing PyTorch and NumPy"),
]


def _run_steps(steps: list[tuple[str, str]]) -> bool:
    """Run every step, on past a failed one; True if all succeeded."""
    success = True
    for cmd, desc in steps:
        if not run_command(cmd, desc):
            success = False
    if success:
        print("\n Installation completed successfully!")
        print(" Check it with: python -m probgan_tpu_torch.cli.install --check")
    else:
        print("\n Some installations failed. Please check the error messages above.")
    return success


def install_colab() -> bool:
    """Install for a hosted GPU runtime."""
    print(" Installing Prot-B-GAN dependencies for Google Colab (GPU runtime)...")
    return _run_steps(_COLAB_STEPS)


def install_local() -> bool:
    """Install for a local environment."""
    print(" Installing Prot-B-GAN dependencies for local environment...")
    return _run_steps(_LOCAL_STEPS)


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------

_PROBES = [
    ("numpy", "NumPy"),
    ("torch", "PyTorch"),
]


def _nvcc_version() -> str | None:
    """``nvcc --version``'s release line, or None without the toolkit."""
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path="/usr/local/cuda/bin")
    if nvcc is None:
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [line.strip() for line in out.splitlines() if "release" in line]
    return lines[0] if lines else out.strip()


def check_installation() -> bool:
    """Import-probe the stack, report versions, the CUDA toolkit and the
    cards. Passes on a machine without a card (the CPU path works there);
    the kernels need a card and ``nvcc``, and their absence is reported."""
    print("Checking Prot-B-GAN installation...")

    success = True
    versions: dict[str, str] = {}
    for module_name, display in _PROBES:
        try:
            mod = importlib.import_module(module_name)
            print(f" {display} - OK")
            version = getattr(mod, "__version__", None)
            if version:
                versions[display] = version
        except ImportError as e:
            print(f" {display} - FAILED: {e}")
            success = False

    print("\n Version Information:")
    for package, version in versions.items():
        print(f"   {package}: {version}")

    report = device_report()
    print("\n CUDA Configuration:")
    print(f"   Default backend: {report['backend']}")
    print(f"   torch.version.cuda: {report['cuda']}")
    nvcc = _nvcc_version()
    print(f"   nvcc: {nvcc or 'not found (the CUDA kernels cannot be built)'}")
    print(f"   Accelerator count: {report['accelerator_count']}")
    for dev in report["devices"]:
        print(f"   Device {dev['id']}: {dev['platform']} ({dev['kind']})")
    if not report["accelerator_count"]:
        print("   No CUDA card: only --device cpu (the plain CPU path) will run")

    if success:
        print("\nAll checks passed! Prot-B-GAN is ready to use.")
        print("Try running: python -m probgan_tpu_torch.cli.infer --help")
    else:
        print("\n Some checks failed. Please reinstall the problematic packages.")
    return success


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Install Prot-B-GAN dependencies")
    parser.add_argument(
        "--colab", action="store_true", help="Install for Google Colab (GPU runtime)"
    )
    parser.add_argument(
        "--local", action="store_true", help="Install for local environment"
    )
    parser.add_argument("--check", action="store_true", help="Check installation")
    args = parser.parse_args(argv)

    if args.colab:
        return 0 if install_colab() else 1
    if args.local:
        return 0 if install_local() else 1
    if args.check:
        return 0 if check_installation() else 1

    print("Please specify installation target:")
    print("  --colab   Install for Google Colab")
    print("  --local   Install for local environment")
    print("  --check   Check existing installation")
    return 1


if __name__ == "__main__":
    sys.exit(main())
