"""Data-parallel training across processes with ``torch.distributed``.

The port of ``alpha_zero_tpu.parallel``. JAX runs one process per host
over a global ``('dp', 'mdl')`` mesh and XLA inserts the collectives; the
port runs **one process per rank** (one per card, or several sharing a
card) and issues each collective itself:

| JAX (``alpha_zero_tpu/``) | port (``alpha_zero_tpu_torch/``) |
|---|---|
| ``multihost.initialize`` (``parallel/multihost.py:39``), from ``cli/train.py:38-45`` | ``multihost.initialize(coordinator_address, num_processes, process_id, device)``: ``init_process_group`` over a TCP store at the address; returns the rank's device |
| ``make_mesh`` / ``make_global_mesh`` (``mesh.py:32``, ``multihost.py:55``) | ``mesh.make_mesh(dp, mdl=1)``; ``mesh.rank_device`` maps a rank to ``cuda:{local_rank % device_count}`` and picks the backend. ``mdl > 1`` raises ``NotImplementedError`` (ROADMAP A10b) |
| ``global_sum`` :118, ``global_game_count`` :166, ``broadcast_from_host0`` :179 | the same names: one ``all_reduce`` of an int64 vector, one ``broadcast`` from rank 0 |
| ``local_to_global`` :67, ``global_to_local`` :85, ``replicate_to_global`` :106, ``host_resident_value`` :134 | none: no global array exists. Each rank holds its own game and train rows and a full replica of the weights, so the evaluator on rank 0 reads its resident weights. The one counterpart is ``broadcast_tensors`` of rank 0's initial state at start-up (a no-op when every rank built it from the shared seed; it stops a mismatch from drifting) |
| XLA's psum of the gradients; Flax BatchNorm's moments over the global sharded batch | ``average_gradients``: one ``all_reduce`` of the flattened gradients and the two losses, divided by the world size; ``models/resnet.py:batch_moments`` sums each BatchNorm layer's Σx, Σx² and count across ranks (autograd through the collective) |
| orbax's collective checkpoint (``training/checkpoint.py:22-33``) | rank 0 writes the single-process path's file, then every rank passes ``barrier``; a checkpoint of one world size resumes in another |

Launching (``cli/train.py``): ``parallel.coordinator_address`` makes this
process rank ``process_id`` of ``num_processes`` (``selfplay_batch_size``
counts its own games, as JAX counts games per host); otherwise
``parallel.dp = k > 1`` spawns k local ranks that split the game batch.
``train.batch_size`` is global in both: each rank samples its share.

Backend: NCCL when every rank on a host has a card of its own, gloo when
ranks share a card or run on the CPU. gloo reduces CUDA tensors by staging
them through the host. A rank whose device is CUDA stays on it.
"""
