"""The port stands alone: importing ``repro_torch`` and running a small
compress/decode on the CPU, serving a field through
``repro_torch.ArchiveServer``, serving the reduced qwen3-4b LM through
``repro_torch.launch.serve`` and training it through
``repro_torch.launch.train`` (with NeurLZ-compressed checkpoints), and
importing the distributed layer (``distributed.sharding``,
``distributed.elastic``, ``launch.mesh``), loads neither JAX nor any
module of ``repro``."""
import os
import subprocess
import sys

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_SCRIPT = """
import sys
import numpy as np
import repro_torch
from repro_torch.data import fields

f = fields.make_fields("hurricane", (5, 12, 10), seed=0)
arc = repro_torch.NeurLZ(epochs=1, device="cpu").compress(f, rel_eb=1e-2)
dec = arc.decode_all()
for name, x in f.items():
    assert np.abs(dec[name].astype(np.float64) - x).max() <= arc["fields"][name]["abs_eb"]
import repro_torch.serve
with repro_torch.ArchiveServer(arc, max_bytes=1 << 30, device="cpu") as srv:
    assert srv.decode("w").tobytes() == dec["w"].tobytes()
import types
import repro_torch.configs
import repro_torch.models.model
import repro_torch.launch.serve
report = repro_torch.launch.serve.serve(types.SimpleNamespace(
    arch="qwen3-4b", batch=2, prompt_len=8, gen=4, seed=0, device="cpu"))
assert report["generated"] == 4
import tempfile
import repro_torch.launch.train
report = repro_torch.launch.train.train(types.SimpleNamespace(
    arch="qwen3-4b", preset="reduced", steps=6, batch=2, seq=32, lr=3e-3,
    seed=0, microbatch=1, ckpt_dir=tempfile.mkdtemp(), ckpt_every=3, keep=2,
    resume=True, lossy_ckpt_eb=1e-5, fail_at_step=None, step_deadline=120.0,
    log_every=0, device="cpu"))
assert report["last_loss"] < report["first_loss"]
import repro_torch.distributed.elastic
import repro_torch.distributed.sharding
import repro_torch.launch.mesh
import repro_torch.optim.grad_compress
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    # One intra-op thread, as the suite's workers run (the port's test
    # files set it): the default, a thread a core, oversubscribes the
    # cores the other workers share and doubles the run even alone.
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
