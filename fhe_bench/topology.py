"""The reference's topology in one process, on loopback sockets.

A copy of the pattern of the program's ``mp/sim.run_full_flow``, split
into what set-up does once (Keygen, Output, three Clients and the Cloud
started, the key plane run) and what a job does (the Clients' values
set, ``OutputNode.submit_job`` timed on the Output's side).  Keygen and
Output work on the host; the Clients encrypt and the Cloud evaluates on
the device.  The Cloud keeps each answer it ships, so that the reference
decrypts the ciphertexts the Cloud produced as well as the values the
Output decoded.
"""

from __future__ import annotations

import time

from ieache_tpu_torch.mp.config import localhost_config
from ieache_tpu_torch.mp.nodes import (
    ClientNode,
    CloudNode,
    KeygenNode,
    OutputNode,
)


class RecordingCloud(CloudNode):
    """The Cloud role, keeping the answer of every job it runs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.answers = []

    def run_job(self, postfix: str):
        answer, op = super().run_job(postfix)
        self.answers.append(answer)
        return answer, op


class Topology:
    """Keygen, Output, a Client per letter and the Cloud, with the key
    plane run: ``pair`` is the keyset pair Keygen serves."""

    def __init__(self, params, pair, letters: list, device,
                 adder: str = "ripple"):
        cfg = localhost_config()
        self.keygen = KeygenNode(params, None, pair=pair, cfg=cfg)
        self.clients, self.cloud, self.output = {}, None, None
        try:
            kaddr = self.keygen.start(cfg.keygen.host, cfg.keygen.key_port)
            self.output = OutputNode(None, cfg=cfg)
            oaddr = self.output.start_indicator_server(
                cfg.output.host, cfg.output.key_port)
            for i, letter in enumerate(letters):
                self.clients[letter] = ClientNode(i + 1, None, cfg=cfg,
                                                  device=device)
            # the key plane, in the reference's admission order: Output,
            # the clients, then the Cloud
            self.output.receive_keys(kaddr)
            for letter in letters:
                self.clients[letter].receive_keys(kaddr)
            self.cloud = RecordingCloud(None, adder=adder, cfg=cfg,
                                        device=device)
            self.cloud.receive_keys(kaddr)
            self.keygen.notify_finished(oaddr)
            self.output.wait_finished()
            self.client_addrs = {
                letter: self.clients[letter].start_data_server(
                    cfg.clients[i].host, cfg.clients[i].data_port)
                for i, letter in enumerate(letters)}
            self.cloud_addr = self.cloud.start_job_server(
                cfg.cloud.host, cfg.cloud.data_port)
        except BaseException:
            self.close()
            raise

    def submit(self, postfix: str, values: dict, width: int):
        """One job: each Client holds its letter's lane values, the
        Output submits ``postfix``; returns (the values the Output
        decoded, seconds from the submission to them)."""
        for letter, v in values.items():
            self.clients[letter].set_value(v, width)
        t0 = time.perf_counter()
        got = self.output.submit_job(self.cloud_addr, postfix,
                                     self.client_addrs)
        return got, time.perf_counter() - t0

    def close(self):
        if self.cloud is not None:
            self.cloud.wait_idle(timeout=60)
        for node in (*self.clients.values(), self.cloud, self.keygen,
                     self.output):
            if node is not None:
                node.stop()
