"""Client of the port's live ``POST /stream`` endpoint (counterpart of
``scripts/stream_client.py``).

Reads a WAV or FLAC file, feeds it to the server as chunked float32 PCM,
optionally paced at real time (a live microphone), and writes the enhanced
stream to a WAV as chunks arrive. Full duplex on one raw socket: enhanced
audio is drained while the request body is still being sent, and the time
from pushing a piece to receiving its last sample enhanced is reported (the
streamer's fixed latency of ``2 * delta`` frames plus one chunk, plus
network and compute).

  python -m speech_enhancement_by_s3prl_tpu_torch.serve --ckpt result/uni --port 8080
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.stream_client noisy.wav out.wav \\
      --url http://localhost:8080/stream --realtime

The server answers 400 with the reason when the served checkpoint cannot
stream (a bidirectional head, upstream or waveform features); the client
then exits with code 2.
"""
from __future__ import annotations

import argparse
import select
import socket
import sys
import time
import urllib.parse

import numpy as np


class ChunkedResponse:
    """Incremental parser: status line and headers, then a chunked body."""

    def __init__(self):
        self.buf = b""
        self.status = None
        self.header = b""
        self.body = b""
        self.done = False
        self.chunked = True
        self._need = None  # bytes left in the current chunk (+ CRLF)

    def feed(self, data: bytes):
        self.buf += data
        if self.status is None:
            if b"\r\n\r\n" not in self.buf:
                return
            self.header, self.buf = self.buf.split(b"\r\n\r\n", 1)
            self.status = int(self.header.split(b" ", 2)[1])
            self.chunked = b"chunked" in self.header.lower()
        if not self.chunked:  # an error reply with a length, read to the close
            self.body, self.buf = self.body + self.buf, b""
            return
        while self.buf and not self.done:
            if self._need is not None:
                take = min(self._need, len(self.buf))
                self.body += self.buf[:take]  # the chunk's CRLF rides along
                self.buf = self.buf[take:]
                self._need -= take
                if self._need == 0:
                    self.body = self.body[:-2]
                    self._need = None
                continue
            if b"\r\n" not in self.buf:
                return
            line, self.buf = self.buf.split(b"\r\n", 1)
            size = int(line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                self.done = True
                return
            self._need = size + 2


def stream(url: str, wav: np.ndarray, sr: int, chunk_ms: float = 100.0,
           realtime: bool = False):
    """Stream ``wav`` (float32 mono at ``sr``) through ``url``; returns (HTTP
    status, enhanced samples or the error body, stats): ``first_audio_s``
    from the first send to the first enhanced sample, ``max_lag_s`` from a
    push to its last sample coming back, ``wall_s``."""
    hop = max(1, int(sr * chunk_ms / 1000.0))
    u = urllib.parse.urlparse(url)
    s = socket.create_connection((u.hostname, u.port or 80), timeout=600)
    resp = ChunkedResponse()
    push_t = []  # (samples sent so far, when that send finished)
    lag_max, t_first = 0.0, None
    try:
        s.sendall(f"POST {u.path or '/stream'} HTTP/1.1\r\n"
                  f"Host: {u.hostname}:{u.port or 80}\r\n"
                  "Content-Type: application/octet-stream\r\n"
                  "Transfer-Encoding: chunked\r\n\r\n".encode())
        t0 = time.monotonic()

        def drain(block=False):
            nonlocal lag_max, t_first
            while True:
                r, _, _ = select.select([s], [], [], None if block else 0.0)
                if not r:
                    return True
                data = s.recv(65536)
                if not data:
                    return False
                before = len(resp.body)
                resp.feed(data)
                if resp.status is not None and resp.status != 200:
                    continue  # read the error body to the end
                if len(resp.body) > before:
                    now = time.monotonic()
                    t_first = now if t_first is None else t_first
                    got = len(resp.body) // 4
                    while push_t and push_t[0][0] <= got:
                        lag_max = max(lag_max, now - push_t.pop(0)[1])
                if resp.done:
                    return False
                if block:
                    return True

        for k in range(0, len(wav), hop):
            if resp.status not in (None, 200):
                break
            piece = wav[k:k + hop].astype("<f4").tobytes()
            if realtime:
                target = t0 + k / sr
                while (left := target - time.monotonic()) > 0:
                    r, _, _ = select.select([s], [], [], left)
                    if not r:
                        break
                    drain()
            try:
                s.sendall(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                break  # the server answered early (an error) and closed
            push_t.append((min(k + hop, len(wav)), time.monotonic()))
            drain()
        if resp.status in (None, 200):
            s.sendall(b"0\r\n\r\n")
        try:
            while not resp.done and drain(block=True):
                pass
        except ConnectionResetError:
            pass
        wall = time.monotonic() - t0
    finally:
        s.close()
    if resp.status != 200:
        return resp.status, resp.body, {}
    return resp.status, np.frombuffer(resp.body, "<f4").copy(), {
        "first_audio_s": (t_first if t_first is not None else t0 + wall) - t0,
        "max_lag_s": lag_max, "wall_s": wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description="client of the port's POST /stream")
    ap.add_argument("infile", help="WAV / FLAC to enhance")
    ap.add_argument("outfile", help="enhanced WAV destination")
    ap.add_argument("--url", default="http://127.0.0.1:8080/stream")
    ap.add_argument("--sample_rate", type=int, default=16000,
                    help="the server's PCM rate (the input is resampled to it)")
    ap.add_argument("--chunk_ms", type=float, default=100.0, help="PCM pushed per chunk")
    ap.add_argument("--realtime", action="store_true",
                    help="pace the chunks at real time instead of as fast as possible")
    args = ap.parse_args(argv)

    from ..data.audio_io import read_audio, resample_poly, write_wav

    wav, sr = read_audio(args.infile)
    wav = wav.mean(0) if wav.shape[0] > 1 else wav[0]
    if sr != args.sample_rate:
        wav = resample_poly(wav, sr, args.sample_rate)
    wav = np.asarray(wav, np.float32)
    status, out, stats = stream(args.url, wav, args.sample_rate, args.chunk_ms,
                                args.realtime)
    if status != 200:
        sys.stderr.write(f"[stream] HTTP {status}: {out.decode(errors='replace')}\n")
        sys.exit(2)
    write_wav(args.outfile, out, args.sample_rate)
    dur = len(wav) / args.sample_rate
    print(f"[stream] {dur:.2f} s of audio in {stats['wall_s']:.2f} s wall "
          f"({dur / max(stats['wall_s'], 1e-9):.1f}x real time), {len(out)} samples out, "
          f"first audio after {stats['first_audio_s']:.3f} s, max push -> enhanced lag "
          f"{stats['max_lag_s'] * 1000.0:.1f} ms")


if __name__ == "__main__":
    main()
