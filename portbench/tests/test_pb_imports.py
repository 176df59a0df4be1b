"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference (with the model kinds, which compose it) loads nothing of the
PyTorch port."""

import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "mpmc_tpu"}


def _loaded_after(imports: str) -> set:
    code = (f"import sys\n{imports}\n"
            "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def _modules(sub: str = ""):
    base = os.path.join(spec.PKG, sub)
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__",
                                                ".cache")]
        for f in files:
            if f.endswith(".py") and "." not in f[:-3]:
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]),
                                      spec.ROOT)
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_benchmark_modules_load_no_jax():
    imports = "\n".join(f"import {m}" for m in _modules())
    imports += ("\nfrom portbench import spec\n"
                "[spec.metric_reader(m['name']) for m in "
                "spec.benchmark()['per_layer']]\n"
                "import portbench.drivers.train, portbench.drivers.predict\n"
                "import mpmc_tpu_torch.cli.experiments, "
                "mpmc_tpu_torch.train.loop, mpmc_tpu_torch.train.graphs")
    loaded = _loaded_after(imports)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "mpmc_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_port():
    """The reference, and the model kinds that hold its heads."""
    imports = "\n".join(f"import {m}" for m in list(_modules("reference"))
                        + list(_modules("kinds")))
    loaded = _loaded_after(imports)
    assert "mpmc_tpu_torch" not in loaded and not loaded & FORBIDDEN
    assert "portbench" in loaded
