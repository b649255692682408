"""Data- and model-parallel training across processes with ``torch.distributed``.

The port of ``alpha_zero_tpu.parallel``. JAX runs one process per host
over a global ``('dp', 'mdl')`` mesh and XLA inserts the collectives; the
port runs **one process per rank** (one per card, or several sharing a
card), ``dp * mdl`` of them, and issues each collective itself:

| JAX (``alpha_zero_tpu/``) | port (``alpha_zero_tpu_torch/``) |
|---|---|
| ``multihost.initialize`` (``parallel/multihost.py:39``), from ``cli/train.py:38-45`` | ``multihost.initialize(coordinator_address, num_processes, process_id, device, mdl)``: ``init_process_group`` over a TCP store at the address, then every model group and data group (``dist.new_group``, in the same order on every rank); returns the rank's device |
| ``make_mesh`` / ``make_global_mesh`` (``mesh.py:32``, ``multihost.py:55``) | ``mesh.make_mesh(world, mdl)`` (raises where JAX's does), ``Mesh.coords(rank) = (rank // mdl, rank % mdl)``, JAX's ``reshape(dp, mdl)`` order; ``multihost.mesh()`` is the process group's; ``mesh.rank_device`` maps a rank to ``cuda:{local_rank % device_count}`` and picks the backend |
| ``_param_spec`` / ``param_shardings`` (``mesh.py:55-73``) | ``mesh.shard_spec(name, shape, mdl)``: the same decision per parameter; ``models/resnet.py`` builds the layers it shards as ``ColumnParallelConv2d`` / ``ColumnParallelLinear``, which hold the rank's output channels |
| ``shard_train_state`` (``mesh.py:76``) | ``build_network(..., mesh=...)`` cuts the whole net drawn from the seed to the rank's slices (``resnet.shard_state_dict``); the optimizer's momentum buffers live beside them; ``training/checkpoint.py`` restores the whole layout into slices |
| ``replicated`` (``mesh.py:46``) | every tensor ``shard_spec`` leaves whole (BatchNorm, dense biases, the layers too narrow to split) is held on every rank; its gradient is averaged over the whole world (``average_gradients``), so the replicas keep the same bits |
| ``batch_sharding`` (``mesh.py:50``) | each model group holds its own rows of the game and train batches; its ranks hold the same rows |
| XLA's all-gather of an ``mdl``-sharded activation and the psum of its input gradient | ``multihost.all_gather_channels`` (forward: gather over the model group; backward: this rank's slice) and ``multihost.copy_to_model`` (forward: identity; backward: sum over the model group) |
| ``global_sum`` :118, ``global_game_count`` :166, ``broadcast_from_host0`` :179 | the same names: one ``all_reduce`` of an int64 vector over a data group (each model group's games once), one ``broadcast`` from rank 0 |
| ``local_to_global`` :67, ``global_to_local`` :85 (its per-row-start dedup of rows replicated over ``mdl``), ``replicate_to_global`` :106, ``host_resident_value`` :134 | none: no global array exists. Each rank holds its model group's rows once, and rank 0's evaluator reads the weights gathered over model group 0 (``gather_state_dict``). The one counterpart is ``broadcast_tensors`` from the first rank of each data group at start-up (a no-op when every rank built its slices from the shared seed; it stops a mismatch from drifting) |
| XLA's psum of the gradients; Flax BatchNorm's moments over the global sharded batch | ``average_gradients``: the slices' gradients averaged over the data group, the replicated ones and the two losses over the world; ``models/resnet.py:batch_moments`` sums each BatchNorm layer's Σx, Σx² and count over the data group (autograd through the collective) |
| orbax's collective checkpoint (``training/checkpoint.py:22-33``) | model group 0 gathers the whole layout, rank 0 writes the single-process path's file, then every rank passes ``barrier``; a checkpoint of one layout resumes in another |

Launching (``cli/train.py``): ``parallel.coordinator_address`` makes this
process rank ``process_id`` of ``num_processes`` (each model group plays
``selfplay_batch_size`` games, as JAX counts games per host); otherwise
``parallel.dp * parallel.mdl > 1`` spawns that many local ranks, whose
model groups split the game batch. ``train.batch_size`` is global in both:
each model group samples its share. ``dryrun.py`` is the counterpart of
``__graft_entry__.dryrun_multichip``.

Backend: NCCL when every rank on a host has a card of its own, gloo when
ranks share a card or run on the CPU. gloo moves CUDA tensors through the
host inside each collective. A rank whose device is CUDA computes on it.
"""
