"""The port's checks on the card, in one command:

    python3 chip_smoke.py

It builds the kernels, then runs the ``cuda`` test cases of ``FILES`` in
this process through pytest, without the conftest (the files import neither
JAX nor the JAX package, so they run where only PyTorch is installed): each
kernel against its plain version on small streams and at full size, and
each path that launches them. It prints a JSON line with the card and the
build's seconds; pytest's report; one line of the launches each path test
counted after its own reset, by kernel (``{"kernels": {kernel: {test:
launches}}}``); and a last line with pytest's exit code, which is also
the script's, and the seconds. The kernels' times are ``kernel_times.py``'s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from tdgs_torch.ops import _build

FILES = (
    "tests/test_torch_kernel_card.py",
    "tests/test_torch_paths_card.py",
    "tests/test_torch_adam.py",
    "tests/test_torch_mcmc_noise.py",
    "tests/test_torch_ut_project.py",
    "tests/test_torch_surfel_project.py",
    "tests/test_torch_trace.py",
    "tests/test_torch_3dgut_trace.py",
    "tests/test_torch_2dgs_trace.py",
)


class Launches:
    """The launches the tests record (``record_property`` names ending in
    ``launches``), by kernel."""

    def __init__(self):
        self.by_kernel: dict[str, dict[str, int]] = {}

    def pytest_runtest_logreport(self, report):
        if report.when != "call":
            return
        test = report.nodeid.split("::", 1)[-1]
        for name, counts in report.user_properties:
            if name.endswith("launches"):
                label = test if name == "launches" else f"{test} {name}"
                for kernel, n in counts.items():
                    self.by_kernel.setdefault(kernel, {})[label] = n


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(json.dumps({"device": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_s": _build.build()}), flush=True)
    launches = Launches()
    t0 = time.perf_counter()
    rc = pytest.main(["--noconftest", "-m", "cuda", "-p", "no:cacheprovider", "-q", "-rfE",
                      "--durations=20", "--rootdir", root,
                      *(os.path.join(root, f) for f in FILES)], plugins=[launches])
    print(json.dumps({"kernels": launches.by_kernel}), flush=True)
    print(json.dumps({"rc": int(rc), "seconds": time.perf_counter() - t0}), flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
