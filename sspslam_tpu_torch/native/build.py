"""``python -m sspslam_tpu_torch.native.build``: compile the native host
library (``csrc/host_ops.cpp``) into ``build/torch_kernels/``."""

import sys

from . import build

if __name__ == "__main__":
    ok = build(verbose=True)
    print("native library " + ("built and loaded" if ok else "BUILD FAILED"))
    sys.exit(0 if ok else 1)
