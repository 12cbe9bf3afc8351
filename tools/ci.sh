#!/usr/bin/env bash
# CI pipeline mirroring the reference's .github/workflows/build.yml
# gates (FractalSharkTest + CLI smoke render, build.yml:215-222):
#   1. full test suite (CPU, 8 virtual devices)
#   2. CLI smoke render of View 0 via Cpu64 → PNG
#   3. tray queue smoke
#   4. graft entry points (single-device + 8-device mesh dryrun)
# Runs on the CPU; on a machine with an NVIDIA GPU, `python chip_smoke.py`
# and `python -m pytest -m gpu tests/` cover the device path.
set -euo pipefail
cd "$(dirname "$0")/.."

export JAX_PLATFORMS=cpu

echo "== tests =="
python -m pytest tests/ -x -q -m 'not slow' -p xdist -n 6 --dist loadfile

echo "== CLI smoke (View 0, Cpu64) =="
python - <<'EOF'
from fractalshark_tpu.cli import main
import os, tempfile
png = os.path.join(tempfile.mkdtemp(), "ci_view0.png")
assert main(["--view", "0", "--render-algorithm", "Cpu64",
             "--width", "128", "--height", "128", "--iterations", "256",
             "--output-png", png, "--stats"]) == 0
from fractalshark_tpu.io.png import read_png
assert read_png(png).shape == (128, 128, 4)
print("CLI smoke OK")
EOF

echo "== tray smoke =="
python - <<'EOF'
import tempfile, os
from fractalshark_tpu.tray import main
d = tempfile.mkdtemp()
loc = os.path.join(d, "locs.txt")
open(loc, "w").write("32 32 -2 -2 2 2 64 1 ci smoke\n")
assert main([loc, "--out-dir", d, "--render-algorithm", "Cpu64"]) == 0
print("tray smoke OK")
EOF

echo "== graft entries =="
python __graft_entry__.py
XLA_FLAGS="--xla_force_host_platform_device_count=8" python - <<'EOF'
import __graft_entry__ as g
g.dryrun_multichip(8)
EOF

echo "CI OK"
