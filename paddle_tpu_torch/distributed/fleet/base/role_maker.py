"""Role makers, PyTorch port: who this process is in the job.

Counterpart of `paddle_tpu/distributed/fleet/base/role_maker.py`, whose
rules this module copies (it is plain Python there too):
`PaddleCloudRoleMaker` reads the launcher's environment
(``TRAINING_ROLE``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_PSERVERS_IP_PORT_LIST``, ...); `UserDefinedRoleMaker` takes the
same facts as arguments.
"""
from __future__ import annotations

import os

__all__ = ["Role", "RoleMakerBase", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = []
        self._server_endpoints = []

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _is_first_worker(self):
        return self._is_worker() and self._current_id == 0

    def _worker_index(self):
        return self._current_id if self._is_worker() else -1

    def _server_index(self):
        return self._current_id if self._is_server() else -1

    def _worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def _server_num(self):
        return len(self._server_endpoints)

    def _get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def _get_pserver_endpoints(self):
        return list(self._server_endpoints)

    def _role_id(self):
        return self._current_id


def _local_endpoints(n):
    return [f"127.0.0.1:{6170 + i}" for i in range(n)]


class UserDefinedRoleMaker(RoleMakerBase):
    """Roles given as arguments: current_id, role (`Role.WORKER` /
    `SERVER`), worker_num, worker_endpoints, server_endpoints."""

    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._current_id = int(kwargs.get("current_id", 0))
        self._role = kwargs.get("role", Role.WORKER)
        self._worker_endpoints = list(
            kwargs.get("worker_endpoints", []) or [])
        if not self._worker_endpoints and "worker_num" in kwargs:
            self._worker_endpoints = _local_endpoints(
                int(kwargs["worker_num"]))
        self._server_endpoints = list(
            kwargs.get("server_endpoints", []) or [])


class PaddleCloudRoleMaker(RoleMakerBase):
    """Roles read from the launcher's environment variables."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        if training_role in ("PSERVER", "SERVER"):
            self._role = Role.SERVER
            self._current_id = int(
                os.environ.get("PADDLE_PSERVER_ID",
                               os.environ.get("POD_INDEX", "0")))
        else:
            self._role = Role.WORKER
            self._current_id = int(
                os.environ.get("PADDLE_TRAINER_ID",
                               os.environ.get("RANK", "0")))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        if not self._worker_endpoints:
            self._worker_endpoints = _local_endpoints(int(
                os.environ.get("PADDLE_TRAINERS_NUM",
                               os.environ.get("WORLD_SIZE", "1"))))
        pep = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in pep.split(",") if e]
