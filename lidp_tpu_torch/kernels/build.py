"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes (no PyTorch headers, so a build
takes seconds).  All sources compile in parallel at first use, into
`lidp_tpu_torch/_build/<hash>/`, keyed by a hash of the sources and flags so
an edited source never loads a stale library.  ptxas's register and spill
report is kept beside each library as `lib<name>.log`.

    python -m lidp_tpu_torch.kernels.build     # build now, print the report
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only on a GPU host")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once.
    Returns {name: path of lib<name>.so}."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out / f"lib{src.stem}.so" for src in _sources()}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"lib{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def report() -> str:
    """ptxas's per-kernel entry names and register/shared-memory/spill
    lines."""
    keep = ("entry function", "registers", "spill")
    lines = []
    for log in sorted(_build_dir().glob("lib*.log")):
        lines += [f"{log.stem[3:]}: {ln.strip()}"
                  for ln in log.read_text().splitlines()
                  if any(k in ln for k in keep)]
    return "\n".join(lines)


@functools.lru_cache(maxsize=None)
def _loaded() -> dict[str, ctypes.CDLL]:
    return {name: ctypes.CDLL(str(path))
            for name, path in build_all().items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded ctypes library built from csrc/<name>.cu."""
    return _loaded()[name]


if __name__ == "__main__":
    build_all()
    print(report())
