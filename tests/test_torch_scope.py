"""The port's microscope stack (emx_torch/scope/{protocol,sim,env,
classifier}.py) against emx's on the CPU, on the same numpy inputs: the
protocol, the simulator's state machine and physics, both file-RPC
sides, the scopectl daemon, the focus metric and its spline argmin, and
the fringe classifier's Adam step.

Tolerances: the noiseless acquire within 2e-5 of emx's (float32 FFTs of
two libraries, away from focus, where the min-max rescale is over a
real contrast range: in focus the image is the FFTs' rounding alone);
the classifier's step in float64 within 1e-10 (emx under
jax.enable_x64); everything else equal."""

import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import emx.scope.classifier as emx_classifier
import emx.scope.env as emx_env
import emx.scope.protocol as emx_protocol
import emx.scope.sim as emx_sim
from emx_torch.scope import classifier, env, protocol, sim
from torch_zoo_helpers import as_emx, emx_variables, ref_jit

CPU = torch.device("cpu")
NATIVE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
BUILD = os.path.join(NATIVE, "build")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


PROGRAM = [
    ("EMSetStageZ", (1.5,)), ("get_img", ("shot1",)),
    ("EMChangeBeamShift", (0.25, -0.5)), ("EMGetFocus", ()),
    ("EMSetStageX", (3.0,)), ("EMSetStageY_Abs", (7.0,)),
    ("EMChangeFocus", (-20.0,)), ("EMGetStageZ", ()), ("terminate", ()),
]


def test_protocol_round_trip_matches_emx():
    """The same wire text both ways, and each decodes the other's."""
    port = [protocol.Instruction(op, a) for op, a in PROGRAM]
    ref = [emx_protocol.Instruction(op, a) for op, a in PROGRAM]
    text = protocol.encode_program(port)
    assert text == emx_protocol.encode_program(ref)
    assert protocol.OPCODES == emx_protocol.OPCODES
    for decode in (protocol.decode_program, emx_protocol.decode_program):
        out = decode(text)
        assert [(i.op, i.args) for i in out] == [(op, a) for op, a in PROGRAM]


def test_simulator_state_machine_matches_emx():
    """Every opcode's state rows equal emx's; the programme's frame (dose
    0, away from focus) within 2e-5."""
    port = sim.SimulatedMicroscope(image_size=32, seed=2, dose=0,
                                   device=CPU)
    ref = emx_sim.SimulatedMicroscope(image_size=32, seed=2, dose=0)
    np.testing.assert_array_equal(port.specimen, ref.specimen)
    prog = [protocol.Instruction(op, a) for op, a in PROGRAM]
    (rows, imgs), (ref_rows, ref_imgs) = port.handle(prog), ref.handle(prog)
    assert rows == ref_rows and port.terminated and ref.terminated
    assert list(imgs) == list(ref_imgs) == [1]
    np.testing.assert_allclose(imgs[1], ref_imgs[1], atol=2e-5)
    assert port.handle([protocol.Instruction("bogus")])[0] == \
        ref.handle([emx_protocol.Instruction("bogus")])[0]


@pytest.mark.parametrize("z, focus, beam", [
    (0.7, 0.0, (0.0, 0.0)), (-2.3, 35.0, (5.0, -3.0)), (1.1, -80.0, (0.0, 9.0))])
def test_noiseless_acquire_matches_emx(z, focus, beam):
    port = sim.SimulatedMicroscope(image_size=48, seed=5, dose=0, device=CPU)
    ref = emx_sim.SimulatedMicroscope(image_size=48, seed=5, dose=0)
    for s in (port, ref):
        s.x, s.y, s.z, s.focus, s.beam = 13.0, 21.0, z, focus, list(beam)
    np.testing.assert_allclose(port.acquire(), ref.acquire(), atol=2e-5)


def test_dosed_acquire_draws_emx_stream():
    """With shot noise the port draws from the scope's numpy generator as
    emx does: counts that move with the FFT's last bits are one count
    (1 / the frame's count range) off, most pixels equal."""
    port = sim.SimulatedMicroscope(image_size=48, seed=9, device=CPU)
    ref = emx_sim.SimulatedMicroscope(image_size=48, seed=9)
    port.z = ref.z = 1.3
    a, b = port.acquire(), ref.acquire()
    assert np.mean(a == b) > 0.99
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_file_marionette_against_both_transports(tmp_path):
    """The port's marionette serves the port's and emx's FileTransport
    alike, and a frame it writes is the simulator's own."""
    scope = sim.SimulatedMicroscope(image_size=24, seed=1, dose=0,
                                    device=CPU)
    twin = sim.SimulatedMicroscope(image_size=24, seed=1, dose=0,
                                   device=CPU)
    paths = dict(change_path=str(tmp_path / "change.txt"),
                 instr_path=str(tmp_path / "instr.txt"),
                 state_path=str(tmp_path / "state.txt"))
    marionette = sim.FileMarionette(scope, img_dir=str(tmp_path / "imgs"),
                                    **paths).start()
    try:
        for mod in (protocol, emx_protocol):
            client = mod.MicroscopeClient(mod.FileTransport(**paths,
                                                            poll_s=0.01))
            client.move_stage_abs(x=4.0, z=2.0)
            assert client.get_stage() == (4.0, 0.0, 2.0)
            twin.x, twin.z = 4.0, 2.0
            np.testing.assert_array_equal(client.get_image(),
                                          twin.acquire())
    finally:
        marionette.stop()


def test_in_process_client_focal_series():
    scope = sim.SimulatedMicroscope(image_size=24, dose=0, device=CPU)
    client = protocol.MicroscopeClient(sim.InProcessTransport(scope))
    client.set_focus(50.0)
    stack = client.collect_focal_series([-100.0, 0.0, 100.0])
    assert stack.shape == (3, 24, 24) and client.get_focus() == 50.0


@pytest.fixture(scope="module")
def daemon():
    """native/build/scopectl on an ephemeral port, 64 px frames, seed 1,
    noiseless (as tests/test_native.py runs it)."""
    exe = os.path.join(BUILD, "scopectl")
    if not os.path.exists(exe):
        r = subprocess.run(["make", "-C", NATIVE], capture_output=True)
        if r.returncode != 0:
            pytest.skip("native build unavailable: "
                        f"{r.stderr.decode()[-200:]}")
    proc = subprocess.Popen([exe, "0", "64", "1", "0"],
                            stdout=subprocess.PIPE)
    line = proc.stdout.readline().decode()
    assert line.startswith("LISTENING ")
    yield int(line.split()[1])
    proc.terminate()
    proc.wait(timeout=5)


def test_socket_transport_against_scopectl(daemon):
    """The port's client drives the C++ daemon as emx's does: the same
    states, the same frame, and the fringe metric lowest in focus."""
    port = protocol.MicroscopeClient(protocol.SocketTransport(port=daemon))
    ref = emx_protocol.MicroscopeClient(
        emx_protocol.SocketTransport(port=daemon))
    port.move_stage_abs(x=5.0, y=6.0, z=1.0)
    assert port.get_stage() == ref.get_stage() == (5.0, 6.0, 1.0)
    port.set_focus(0.0)
    a = port.get_image()
    np.testing.assert_array_equal(a, ref.get_image())
    assert a.shape == (64, 64) and 0.0 <= a.min() and a.max() <= 1.0
    ks = {}
    for z in (-2.0, 0.0, 2.0):
        port.move_stage_abs(z=z)
        ks[z] = env.fresnel_quantifier(port.get_image())
    assert ks[0.0] < ks[-2.0] and ks[0.0] < ks[2.0]
    port.transport.close()
    ref.transport.close()


def test_fresnel_quantifier_and_spline_min_match_emx():
    rng = np.random.default_rng(3)
    for img in (rng.random((40, 40)), np.zeros((8, 8)),
                rng.poisson(50.0, (32, 32)) / 50.0):
        for rectify in (True, False):
            assert env.fresnel_quantifier(img, rectify) == \
                emx_env.fresnel_quantifier(img, rectify)
    xs = np.linspace(-1.5, 1.5, 9)
    for ys in (rng.random(9), (xs - 0.3) ** 2, np.cos(3 * xs)):
        assert env._spline_min(xs, ys, 8) == emx_env._spline_min(xs, ys, 8)
    # The scipy-free fallback (a parabola around the argmin).
    short = np.array([0.0, 1.0]), np.array([1.0, 0.5])
    assert env._spline_min(*short, 8) == emx_env._spline_min(*short, 8)


def test_fresnel_env_episode_matches_emx():
    """FresnelEnv and StackedFresnelEnv on the noiseless port simulator
    against emx's: the scan target, the start and every step's frame,
    reward and distance."""
    def make(mod_env, mod_proto, mod_sim, **kw):
        scope = mod_sim.SimulatedMicroscope(image_size=32, dose=0, **kw)
        inner = mod_env.FresnelEnv(
            mod_proto.MicroscopeClient(mod_sim.InProcessTransport(scope)),
            max_shift=1.0, max_z_dist=2.0, z_scan_points=7,
            max_episode_steps=4, seed=4, scan_halfwidth=1.5)
        return mod_env.StackedFresnelEnv(inner)

    port = make(env, protocol, sim, device=CPU)
    ref = make(emx_env, emx_protocol, emx_sim)
    a, b = port.reset(), ref.reset()
    assert port.target_z == ref.target_z and port.z == ref.z
    np.testing.assert_allclose(a, b, atol=2e-5)
    for shift in (0.5, -0.25, 1.0, 0.75):
        (a, ra, da, ia), (b, rb, db, ib) = port.step([shift]), ref.step([shift])
        assert (ra, da, ia) == (rb, db, ib)
        np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("n", [3])
def test_collect_fringe_dataset_matches_emx(n):
    port = sim.SimulatedMicroscope(image_size=32, seed=0, dose=0, device=CPU)
    ref = emx_sim.SimulatedMicroscope(image_size=32, seed=0, dose=0)
    (x, y), (rx, ry) = (classifier.collect_fringe_dataset(port, n, seed=2),
                        emx_classifier.collect_fringe_dataset(ref, n, seed=2))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_allclose(x[y > 0.5], rx[ry > 0.5], atol=2e-5)


def test_classifier_step_matches_emx_in_float64():
    """One Adam step of the classifier on a batch, port against emx's
    step (emx/scope/classifier.py:62-70, restated: it is a closure), in
    float64 on both sides; then the forward of emx's parameters."""
    model = emx_classifier.FringeClassifier()
    rng = np.random.default_rng(0)
    x = rng.random((6, 16, 16))
    y = (rng.random(6) > 0.5).astype(np.float64)
    params = emx_variables(model, jnp.zeros((1, 16, 16)))["params"]
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64),
            as_emx({"params": params})["params"])
        opt = optax.adam(1e-3)

        @ref_jit
        def step(p, s, xb, yb):
            def loss_fn(q):
                logits = model.apply({"params": q}, xb)
                return jnp.mean(optax.sigmoid_binary_cross_entropy(logits,
                                                                   yb))
            loss, g = jax.value_and_grad(loss_fn)(p)
            u, s = opt.update(g, s)
            return optax.apply_updates(p, u), loss

        new, loss = step(p64, opt.init(p64), jnp.asarray(x), jnp.asarray(y))
        new = {k: np.asarray(v) for k, v in _flat(new).items()}
    net = classifier.FringeClassifier(dtype=torch.float64, device=CPU)
    classifier.load_classifier(net, params)
    opt_t = torch.optim.Adam(net.parameters(), lr=1e-3)
    loss_t = classifier.classifier_step(net, opt_t, torch.from_numpy(x),
                                        torch.from_numpy(y))
    assert abs(float(loss_t) - float(loss)) < 1e-12
    got = {k: v.detach().numpy() for k, v in _port_flat(net).items()}
    for k, v in new.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-10,
                                   err_msg=k)


def _flat(tree) -> dict:
    from flax.traverse_util import flatten_dict

    return {k: v for k, v in flatten_dict(tree, sep="/").items()}


def _port_flat(net) -> dict:
    """flax-layout float64 copies of the port's parameters."""
    from emx_torch.serve.convert import _tensors

    out = {}
    for coll, key, t, _, change in _tensors(net):
        a = t.detach().cpu().numpy()
        out[key] = torch.from_numpy(np.ascontiguousarray(
            change(a) if change is not None else a))
    return out


def test_classifier_trains_on_simulator_labels():
    """emx's tests/test_aux.py recipe, smaller: the loss falls and the
    labels are learnt; load_classifier carries emx-layout parameters."""
    scope = sim.SimulatedMicroscope(image_size=32, seed=0, device=CPU)
    x, y = classifier.collect_fringe_dataset(scope, 12, seed=0)
    res = classifier.train_fringe_classifier(x, y, steps=120, device=CPU)
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10])
    assert res.accuracy > 0.8
    twin = classifier.load_classifier(
        classifier.FringeClassifier(device=CPU), res.params)
    with torch.no_grad():
        torch.testing.assert_close(twin(torch.from_numpy(x)),
                                   res.model(torch.from_numpy(x)))
