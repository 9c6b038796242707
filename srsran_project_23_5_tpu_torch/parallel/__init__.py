"""Scale-out over ranks: carrier and slot meshes on ``torch.distributed``
(``mesh``), the slot-sharded PRACH stream (``slot_stream``) and the
launcher that starts the ranks (``launch``).

Counterpart of ``srsran_project_23_5_tpu/parallel/``.  JAX runs one
process over N devices (``shard_map``, ``ppermute``); here each rank is a
process with one device, the mesh is a ``DeviceMesh`` over the ranks, and
each rank runs the per-shard body on its own slice.  Importing these
modules starts no process group.
"""
