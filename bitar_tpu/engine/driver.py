"""Driver: device discovery and stream topology.

The analog of ``CompressDriver`` (reference ``src/driver.cc``): a
per-process singleton that enumerates accelerator devices and constructs
engines with a stream->device placement map.

The reference's topology work is reading PCI ids from sysfs and dividing
worker lcores round-robin across devices (``driver.cc:75-158``).  Here
discovery is ``jax.devices()``, the "PCI-id -> device class" dispatch is
platform -> ``DeviceCapabilities``, and the lcore distribution becomes a
round-robin assignment of streams to local devices.  Multi-host process
topology comes from ``jax.process_index``/``process_count`` (populated by
``jax.distributed.initialize`` in multi-process jobs).
"""

from __future__ import annotations

import threading

import jax

from ..config import EngineConfig, capabilities_for_platform
from ..status import Status, StatusError
from ..utils.logging import get_logger
from .device import Engine

logger = get_logger("engine.driver")


class Driver:
    """Singleton device discovery + engine factory (reference
    ``CompressDriver::Instance``, ``driver.cc:162-166``)."""

    _instance: "Driver | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._engines: list[Engine] = []

    @classmethod
    def instance(cls) -> "Driver":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Driver()
            return cls._instance

    @classmethod
    def _reset_for_tests(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    # -- discovery -----------------------------------------------------
    def list_available_devices(self) -> list:
        """Local accelerator devices (reference ``ListAvailableDeviceIds``,
        ``driver.cc:173-190``)."""
        return jax.local_devices()

    def describe(self) -> dict:
        devs = self.list_available_devices()
        return {
            "process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": [str(d) for d in devs],
            "global_device_count": jax.device_count(),
            "device_class": capabilities_for_platform(
                devs[0].platform).name if devs else None,
        }

    # -- engine construction -------------------------------------------
    def get_engines(self, config: EngineConfig,
                    device_ids: list[int] | None = None) -> list[Engine]:
        """Build one initialized engine per requested local device
        (reference ``GetDevices`` + ``CreateDevices``,
        ``driver.cc:100-158,192-223``)."""
        devices = self.list_available_devices()
        if not devices:
            raise StatusError(Status.Invalid("no accelerator devices visible"))
        if device_ids is None:
            device_ids = list(range(len(devices)))
        for d in device_ids:
            if not (0 <= d < len(devices)):
                raise StatusError(Status.Invalid(
                    f"device id {d} out of range [0, {len(devices)})"))
        engines = [Engine(config, device=devices[d], device_index=d).initialize()
                   for d in device_ids]
        self._engines.extend(engines)
        logger.info("driver created %d engine(s) on %s",
                    len(engines), [str(devices[d]) for d in device_ids])
        return engines

    @staticmethod
    def place_streams(num_streams: int, engines: list[Engine]
                      ) -> list[Engine]:
        """Round-robin stream->engine placement, every engine getting at
        least one stream when possible (the lcore split policy of
        ``CreateDevices``, ``driver.cc:100-158``)."""
        if not engines:
            raise StatusError(Status.Invalid("no engines to place streams on"))
        return [engines[i % len(engines)] for i in range(num_streams)]
