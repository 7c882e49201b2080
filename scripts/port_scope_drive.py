"""The scope daemon drive on the port's client (the twin of
scripts/scope_drive.py, no JAX): native/build/scopectl on an ephemeral
port, a FresnelEnv episode of the oracle policy through
emx_torch.scope's SocketTransport (it must end within max_episode_steps,
within 0.2 of the scan's target), a focal series, then the daemon's
terminate.

    make -C native && python scripts/port_scope_drive.py
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from emx_torch.scope import (FresnelEnv, MicroscopeClient,  # noqa: E402
                             SocketTransport)

proc = subprocess.Popen([os.path.join(ROOT, "native", "build", "scopectl"),
                         "0", "64", "2", "0"], stdout=subprocess.PIPE,
                        text=True)
try:
    m = re.match(r"LISTENING (\d+)", proc.stdout.readline())
    assert m, "scopectl did not report its port"
    port = int(m.group(1))
    print("daemon port", port, flush=True)
    client = MicroscopeClient(SocketTransport(port=port))
    env = FresnelEnv(client, max_shift=1.0, max_z_dist=0.7, z_scan_points=7,
                     max_episode_steps=12, seed=0)
    obs = env.reset()
    print("obs", obs.shape, "target_z", round(env.target_z, 3), flush=True)
    done, steps = False, 0
    while not done:
        shift = np.clip(env.target_z - env.z, -1.0, 1.0)
        obs, reward, done, info = env.step([shift])
        steps += 1
    print(f"oracle episode: steps={steps} final distance="
          f"{info['distance']:.4f}", flush=True)
    assert steps <= 12 and info["distance"] < 0.2, (steps, info)
    stack = env.collect_focal_series([-100.0, 0.0, 100.0])
    print("focal series", np.asarray(stack).shape, flush=True)
    assert np.asarray(stack).shape[0] == 3
    env.close()
    proc.wait(timeout=10)
finally:
    if proc.poll() is None:
        proc.terminate()
        proc.wait(timeout=10)
print("SCOPE DRIVE PASSED", flush=True)
