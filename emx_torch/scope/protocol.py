"""Microscope control protocol (copy of emx/scope/protocol.py: numpy
and sockets, no torch): the reference's opcode table
(em_env/em_env.py:47-62) over two interchangeable transports:

  * FileTransport  — bit-compatible with the reference's file-based RPC
    (instr file + change-flag file + state file, em_env.py:70-122), so
    the original DigitalMicrograph-side marionette script keeps working.
  * SocketTransport — newline-delimited TCP to the C++ acquisition daemon
    (native/scopectl.cc), the production path: no polling, no shared
    filesystem, binary image transfer.

Instruction wire format (both transports): opcode index, then one line
per argument, instruction terminated by a blank-separated chain; state
reply is CSV rows `code,payload`.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Sequence

import numpy as np

# Opcode order is the wire protocol — matches reference em_env.py:47-62.
OPCODES = (
    "get_img",          # 1 arg: name to save image as
    "EMSetStageX",      # 1 arg: relative stage X shift
    "EMSetStageY",      # 1 arg: relative stage Y shift
    "EMSetStageZ",      # 1 arg: relative stage Z shift
    "EMChangeBeamShift",  # 2 args: beam shift dx, dy
    "EMSetStageX_Abs",  # 1 arg: absolute X
    "EMSetStageY_Abs",  # 1 arg: absolute Y
    "EMSetStageZ_Abs",  # 1 arg: absolute Z
    "EMGetStageX",      # 0 args
    "EMGetStageY",      # 0 args
    "EMGetStageZ",      # 0 args
    "EMChangeFocus",    # 1 arg: delta focus
    "EMGetFocus",       # 0 args
    "EMSetFocus",       # 1 arg: new focus
    "terminate",        # 0 args
)
OPCODE_INDEX = {name: i for i, name in enumerate(OPCODES)}


@dataclasses.dataclass
class Instruction:
    op: str
    args: tuple = ()

    def encode(self) -> str:
        lines = [str(OPCODE_INDEX[self.op])]
        lines += [str(a) for a in self.args]
        return "\n".join(lines) + "\n"


def encode_program(instructions: Sequence[Instruction]) -> str:
    return "".join(i.encode() for i in instructions)


def decode_program(text: str) -> list[Instruction]:
    """Inverse of encode_program: parse opcode + following arg lines.
    Arg counts come from the opcode table."""
    argc = {
        "get_img": 1, "EMSetStageX": 1, "EMSetStageY": 1, "EMSetStageZ": 1,
        "EMChangeBeamShift": 2, "EMSetStageX_Abs": 1, "EMSetStageY_Abs": 1,
        "EMSetStageZ_Abs": 1, "EMGetStageX": 0, "EMGetStageY": 0,
        "EMGetStageZ": 0, "EMChangeFocus": 1, "EMGetFocus": 0,
        "EMSetFocus": 1, "terminate": 0,
    }
    lines = [ln for ln in text.splitlines() if ln.strip() != ""]
    out: list[Instruction] = []
    i = 0
    def conv(a: str):
        try:
            return float(a)
        except ValueError:
            return a  # get_img takes a string tag

    while i < len(lines):
        op = OPCODES[int(lines[i])]
        n = argc[op]
        args = tuple(conv(a) for a in lines[i + 1 : i + 1 + n])
        out.append(Instruction(op, args))
        i += 1 + n
    return out


class FileTransport:
    """File-RPC parity transport (reference em_env.py:70-122): write the
    instruction file, create the change-flag file, poll until the
    marionette removes the flag, then read the state file."""

    def __init__(self, change_path: str, instr_path: str, state_path: str,
                 poll_s: float = 0.05, timeout_s: float = 30.0):
        self.change_path = change_path
        self.instr_path = instr_path
        self.state_path = state_path
        self.poll_s = poll_s
        self.timeout_s = timeout_s

    def execute(self, instructions: Sequence[Instruction]) -> list[list[str]]:
        with open(self.instr_path, "w") as f:
            f.write(encode_program(instructions))
        with open(self.change_path, "w") as f:
            f.write("1")
        deadline = time.monotonic() + self.timeout_s
        while os.path.isfile(self.change_path):
            if time.monotonic() > deadline:
                raise TimeoutError("microscope marionette did not respond")
            time.sleep(self.poll_s)
        state: list[list[str]] = []
        with open(self.state_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    state.append(line.split(","))
        return state

    def close(self) -> None:
        pass


class SocketTransport:
    """TCP transport to the acquisition daemon. Program is sent as
    `EXEC <nbytes>\\n<program>`; reply is `STATE <nrows>\\n` + rows.
    Image payloads are returned inline as `IMG <h> <w>\\n` + raw float32."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9870,
                 timeout_s: float = 30.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock: socket.socket | None = None
        self.last_image: np.ndarray | None = None

    def _connect(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, self.timeout_s)
            self._file = self._sock.makefile("rb")
        return self._sock

    def execute(self, instructions: Sequence[Instruction]) -> list[list[str]]:
        sock = self._connect()
        program = encode_program(instructions).encode()
        sock.sendall(f"EXEC {len(program)}\n".encode() + program)
        state: list[list[str]] = []
        header = self._file.readline().decode().split()
        if not header or header[0] != "STATE":
            raise IOError(f"bad daemon reply: {header}")
        nrows = int(header[1])
        for _ in range(nrows):
            row = self._file.readline().decode().strip()
            if row.startswith("IMG "):
                _, h, w, tag = row.split()
                nbytes = int(h) * int(w) * 4
                buf = self._file.read(nbytes)
                self.last_image = np.frombuffer(buf, np.float32).reshape(
                    int(h), int(w)
                ).copy()
                state.append(["0", tag])
            else:
                state.append(row.split(","))
        return state

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class MicroscopeClient:
    """High-level client used by environments and data-collection scripts —
    the EM_Env capability set (em_env/em_env.py:29-127) over any transport."""

    def __init__(self, transport):
        self.transport = transport
        self._img_counter = 0

    def execute(self, instructions: Sequence[Instruction]) -> list[list[str]]:
        return self.transport.execute(instructions)

    def _query(self, op: str) -> float:
        state = self.execute([Instruction(op)])
        return float(state[0][-1])

    def get_image(self) -> np.ndarray:
        self._img_counter += 1
        tag = f"img_{self._img_counter}"
        state = self.execute([Instruction("get_img", (tag,))])
        return self._image_from_state(state)

    def _image_from_state(self, state) -> np.ndarray:
        img = getattr(self.transport, "last_image", None)
        if img is not None:
            return img
        # File transport: state rows are (code, image_path).
        for row in state:
            if row[0] == "0" and len(row) > 1:
                from emx_torch.io.tiff import read_tiff

                return read_tiff(row[1].strip())
        raise IOError("no image in microscope state")

    def shift_stage(self, dx: float = 0.0, dy: float = 0.0, dz: float = 0.0):
        instrs = []
        if dx:
            instrs.append(Instruction("EMSetStageX", (dx,)))
        if dy:
            instrs.append(Instruction("EMSetStageY", (dy,)))
        if dz:
            instrs.append(Instruction("EMSetStageZ", (dz,)))
        if instrs:
            self.execute(instrs)

    def move_stage_abs(self, x=None, y=None, z=None):
        instrs = []
        if x is not None:
            instrs.append(Instruction("EMSetStageX_Abs", (x,)))
        if y is not None:
            instrs.append(Instruction("EMSetStageY_Abs", (y,)))
        if z is not None:
            instrs.append(Instruction("EMSetStageZ_Abs", (z,)))
        if instrs:
            self.execute(instrs)

    def get_stage(self) -> tuple[float, float, float]:
        return (self._query("EMGetStageX"), self._query("EMGetStageY"),
                self._query("EMGetStageZ"))

    def get_focus(self) -> float:
        return self._query("EMGetFocus")

    def set_focus(self, f: float) -> None:
        self.execute([Instruction("EMSetFocus", (f,))])

    def change_focus(self, df: float) -> None:
        self.execute([Instruction("EMChangeFocus", (df,))])

    def beam_shift(self, dx: float, dy: float) -> None:
        self.execute([Instruction("EMChangeBeamShift", (dx, dy))])

    def collect_focal_series(self, defocuses: Sequence[float]) -> np.ndarray:
        """Focal-series stack collection (reference
        em_env/fresnel_env.py:277-328): step focus, grab, restore."""
        f0 = self.get_focus()
        stack = []
        for df in defocuses:
            self.set_focus(f0 + df)
            stack.append(self.get_image())
        self.set_focus(f0)
        return np.stack(stack)

    def terminate(self) -> None:
        try:
            self.execute([Instruction("terminate")])
        except Exception:
            pass
        self.transport.close()
