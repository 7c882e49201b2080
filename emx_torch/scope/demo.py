"""Interactive/manual microscope driver (port of emx/scope/demo.py): the
em_env/tester.py workflow.

Usage:
  python -m emx_torch.scope.demo                 # in-process simulator
  python -m emx_torch.scope.demo --port=9870     # against a scopectl daemon
  python -m emx_torch.scope.demo --autofocus     # run a DQN autofocus episode
  python -m emx_torch.scope.demo --device=cpu    # simulator and agent on the CPU

Prints the state after each scripted command; with --autofocus, trains a
tiny DQN for a few episodes on the autofocus task and reports returns.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0,
                        help="scopectl TCP port (0 = in-process simulator)")
    parser.add_argument("--autofocus", action="store_true")
    parser.add_argument("--episodes", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu")
    args = parser.parse_args(argv)

    from emx_torch.scope import FresnelEnv, MicroscopeClient, fresnel_quantifier

    if args.port:
        from emx_torch.scope import SocketTransport

        client = MicroscopeClient(SocketTransport(port=args.port))
    else:
        from emx_torch.scope.sim import InProcessTransport, SimulatedMicroscope

        client = MicroscopeClient(InProcessTransport(
            SimulatedMicroscope(image_size=64, dose=0, device=args.device)))

    print("stage:", client.get_stage(), "focus:", client.get_focus())
    client.move_stage_abs(x=32.0, y=16.0)
    client.shift_stage(dz=1.0)
    print("after moves:", client.get_stage())
    img = client.get_image()
    print(f"frame: {img.shape}, range [{img.min():.3f}, {img.max():.3f}], "
          f"fringe metric {fresnel_quantifier(img):.3f}")
    stack = client.collect_focal_series([-100.0, 0.0, 100.0])
    print("focal series:", stack.shape)

    if args.autofocus:
        from emx_torch.scope.dqn import DQNAgent, DQNConfig, train_autofocus

        env = FresnelEnv(client, max_shift=1.0, max_z_dist=0.7,
                         z_scan_points=7, max_episode_steps=8)
        agent = DQNAgent(env.observation_space.shape,
                         DQNConfig(warmup=16, eps_decay_steps=100),
                         device=args.device)
        returns = train_autofocus(env, agent, episodes=args.episodes)
        print("episode returns:", returns)

    client.terminate()


if __name__ == "__main__":
    main()
