"""Multi-process and multi-device parts of the port: the process group and
its transports (`distributed`) and the hash-sharded contig index over a
(data, idx) grid of devices (`sharded_index`). Counterpart of
``ntlink_tpu/parallel``; the data-parallel split over several local
devices lives in `device_map.TorchMapper`."""
