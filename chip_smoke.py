#!/usr/bin/env python3
"""Smoke run of challenge_tpu_torch, the PyTorch + CUDA port, on one GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of the
                                     # vad v8 (float32 and bfloat16), se,
                                     # eff B0 v1, density B4 and vad v9
                                     # steps
    python3 chip_smoke.py --cudnn-ab # also the model step with cuDNN's
                                     # algorithm timing off and on, each in
                                     # a fresh process (off, on, on, off)

Phases, in order; any failure raises, and the script then exits non-zero
without the result line:

1. build every hand-written CUDA kernel from challenge_tpu_torch/csrc with
   nvcc for sm_90a, one nvcc per source, all started together, and print
   the build seconds and ptxas' report for all twelve instances
   (csrc/synth.cu: magnitude, flat-complex output and the se triple;
   csrc/synth_mel.cu: the fused mel; each for float32, bfloat16 and int8
   banks);
2. make random spec banks on the card at a realistic size (32 backgrounds
   of 1,875 frames, 512 voices of 40-130 frames, 128 noises of 20-100,
   each [257, T, 4] float32, from a seed), as float32, bfloat16 and int8
   banks from the same sources;
3. hold the float32 magnitude kernel against its plain PyTorch version on
   the card: bit for bit (tolerance 0.0: both round every multiply and add
   of the same ordered sum and take the IEEE root), on draws of the main
   path (batch 12, 512 frames, 7 voice and 2 noise slots) and on
   adversarial draws (negative shifts, shifts of n_frame and beyond,
   inactive slots, long then short clips, no noise bank, a ragged row
   tile, and misaligned ranges: background windows at odd row offsets and
   clip banks of 13 and 25 rows, at 1,028 and 514 columns, batch 6 and
   batch 1, so that staged rows start at every residue mod 16 bytes the
   element size allows), and on the density trainer's batches (12 x 2,048
   frames, 10 voice and 6 noise slots) from banks built for 2,048 frames,
   whose 1,875-frame backgrounds are wrapped;
3b. the same for the bfloat16 and int8 magnitude kernels, on banks built
   from the same sources (the density batches included) and on the
   adversarial cases with their banks rounded or quantized: bit for bit
   (both upcast exactly, sum in float32 in order, take the IEEE root and
   round it once to bfloat16);
3c. the same for the three flat-complex kernels (the raw window, rounded
   once to bfloat16 for the low-precision banks), bit for bit, on the main
   path's draws, the adversarial cases and the se triple's calls: the mix
   with every voice weight zeroed, the voices over the one-item zero
   background bank with a unit background scale, and that call with every
   voice slot inactive; then the three se triple kernels, each of their
   three outputs against the plain calls and against the single-call
   kernels, bit for bit, on the main path's draws, the adversarial cases
   and a mix with every voice slot inactive;
3d. the same for the three fused mel kernels, mel and min/max, bit for
   bit (both take the float32 root, the {0,1} masks and the mel sum over
   the nonzero band in increasing order, every product and sum rounded),
   on the main path's draws (vad v9, batch 12, 512 frames) with training
   masks, eval masks (all ones) and the filter columns, on batch 1, on a
   sample whose time mask zeroes every frame (its min and max must be 0),
   on the adversarial cases, and on draws at 40 and 128 mel bins (each
   with its own band), 500 frames (a ragged last row tile), batch 48
   (more row tiles than the card holds blocks at once) and the density
   trainer's batch, 12 x 2,048 frames with its column mask (no filter
   columns), on banks built for 2,048 frames;
4. check the port on the card against the port on the CPU on a small
   input: synthesis bit for bit, log-mel within 1e-5 mean abs error,
   labels exact, and one training-mode forward and loss within 1e-5
   relative;
4b. int8 synthesis on the card against the CPU on that input, bit for bit;
4c. the se path on a small input (batch 2, 32 frames): synthesis, targets
   and features bit for bit against the CPU in each bank dtype; then one
   training-mode forward of the full-width pretrain cascade and
   ``se_loss``, the card's float32 held to a float64 CPU copy within 1e-5
   of each output's peak or 10 times the CPU float32's distance;
4d. the fused mel path on a small input (batch 4, 80 mels, 64 frames):
   the kernel's mel and min/max and the labels bit for bit against the
   CPU on the same draws and masks, the log-mel within 2 float32 ulps
   (each device's own log); then one training-mode forward and loss of
   full-width vad v6, v7 and v9, held to float64 as in 4c;
4e. the eff family on a small input (batch 2, B0, 40 mels, 256 frames):
   one training-mode forward and BCE loss of each head (v1, v3, v5, v6,
   v7), every copy given the same keep masks of stochastic depth (drawn
   once from a CPU generator), held to float64 as in 4c;
4f. the density model on a small input (batch 2, B0 with the density head
   and 2 gated layers, 40 mels, 256 frames): one training-mode forward
   and one training step (``density_loss``, the kernel penalty,
   AdaBelief with clipvalue), the same keep masks on every copy: the
   forward and its loss on the card within 1e-5 of the peak from a float64
   CPU copy; the step's gradients within 2e-5 of the peak over all tensors
   and 5e-5 of each tensor's own peak; the update moving every tensor that
   has a gradient and no other, the card's new weights within 4 float32
   epsilons of (|weight| + lr) from AdaBelief in float64 on the card's own
   weights and gradients;
4g. ``compute_dtype='bfloat16'`` on the shapes of 4-4f (vad v8 and v9,
   eff B0 v5 and v7, se v9 pretrain, the density head): one set of
   weights, input and labels on the card, on the CPU and in a float64
   copy computing in float64; one training-mode forward, its loss and
   every parameter's gradient; the card's distance from float64 (largest
   over the peak) at most twice the CPU's, for the outputs with the loss
   and for the gradients;
5. the main path: ``get_model(Config(model_type='vad', v=8))`` at full width
   (base 48, td_dim 1024, 80 mels, 512 frames, batch 12),
   ``DevicePipeline`` and ``TrainLoop.fit`` for 5 training steps and 1
   validation step, with the kernel launch counts set to 0 just before and
   read just after: every batch must have gone through the kernel, and
   the losses must be finite;
5b. the se slice's main path: ``get_model(Config(model_type='se', v=9,
   pretrain=True))`` at full width (U-Net 64-512, head base 32 and td_dim
   1024, input [12, 256, 512, 2]) on float32 banks, ``DevicePipeline`` and
   ``TrainLoop.fit`` for 3 training steps and 1 validation step; then the
   finetune model, given those weights, for the same. Each run's counts
   are set to 0 just before and read just after: the float32 se triple
   kernel must have run once a batch and nothing else; the frozen half's
   weights and BN statistics must be bit-identical before and after, every
   tensor of the trained half must move, and the losses (class, speech,
   noise, validation class ER) must be finite;
5c. this slice's main path: ``get_model(Config(model_type='vad', v=9))``
   at full width (base 32, td_dim 1024, 80 mels, 512 frames, batch 12,
   BiLSTM head) trained by ``TrainLoop.fit`` from an iterator over
   ``FeatureFn(cfg, fused_mel=True)`` on float32 banks, 5 training steps and
   1 validation step; then v6 and v7 for 2 steps each on the same path, and
   v9 for 2 steps each on bfloat16 and int8 banks. Each run's counts are
   set to 0 just before and read just after: the mel kernel of the banks'
   dtype must have run once a batch and no other kernel, and every logged
   value must be finite;
5d. full-width vad v8 with n_chan 3 on bfloat16 banks and 4 on float32
   banks through ``DevicePipeline``'s complex branch, 2 steps each: the
   flat-complex kernel of the banks' dtype once a batch and nothing else,
   features and model inputs 3 and 4 wide; and
   n_chan 1, whose card features keep 2 channels (the reference's
   ``mono_chan`` quirk) and whose training raises the port's ValueError;
5e. this slice's main path: ``get_model(Config(model_type='eff'))`` at
   full width (EfficientNetB0, the v1 head, 80 mels, 512 frames, batch 12,
   5,012,155 parameters) on float32 banks, ``DevicePipeline`` and
   ``TrainLoop.fit`` for 5 training steps and 1 validation step; then B0
   v3, v5, v6 and v7 and B7 v6 (69,891,539 parameters, the largest
   backbone) for 2 steps each. Each run's counts are set to 0 just before
   and read just after: the float32 magnitude kernel must have run once a
   batch and no other kernel, every logged value must be finite, and the
   epoch's dropout generator must have been drawn (stochastic depth ran on
   the card); each run's peak device memory above what the earlier phases
   hold is kept;
5f. this slice's main path, the density trainer at its defaults
   (EfficientNetB4 with the density head, 80 mels, 2,048 frames, batch
   12, n_layers 0, AdaBelief at lr 1e-4 with clipvalue 0.01, the count +
   TV loss with the l2 1e-6 kernel penalty, label multiplier 10) with
   ``--n_chan 2``, on float32 banks built for 2,048 frames:
   ``get_density_model``, ``DevicePipeline(variant='density')`` and
   ``TrainLoop(loss_fn=...).fit`` for 5 training steps and 1 validation
   step (the float32 magnitude kernel once a batch and no other kernel;
   finite logs whose only metric is cos_sim), then 2 steps through
   ``FeatureFn(variant='density', fused_mel=True)`` (the float32 mel
   kernel once a batch), the fused and unfused features of one generator
   state (rtol 1e-4, atol 1e-5, labels equal, as
   tests/test_pallas_synth.py:553-558 holds JAX's), and the step (10
   steps), the batch pipeline and the model step timed as in phase 6,
   with the run's peak device memory, printed on the ``DENSITY`` line;
5g. the fused training step (``parallel/train.py``: the draws, synthesis,
   features, forward, backward and update of a step captured as one CUDA
   graph and replayed, as ``TrainLoop`` runs it in banks mode) at full
   width, batch 12, on float32 banks, for vad v8, eff B0 v1 and se v9
   pretrain: the graphed step against its plain version (the same
   composition, eager) from the same seed for 4 steps, the weights, BN
   statistics, Adam's moments and step and the metrics held bit for bit,
   or within the gap between two plain runs where cuDNN's atomics part
   them (both gaps printed); the graphed call's launches, its replays'
   included, once a batch; for vad v8 and eff B0 v1 ``steps_per_call=4``
   against 4 calls of 1, ``grad_accum=2`` graphed against its plain
   version, and ``remat`` against none, with the peak memory of 2 plain
   steps (cuDNN's algorithm search included where the shapes are new)
   and of the graphed call after them; the density trainer's configuration (B4 at 2,048 frames) with
   ``grad_accum=2`` in banks mode with and without remat, with their
   peaks; and the graphed step (``fused_step_ms``) and the eager one
   (``eager_fused_step_ms``) timed in turns (graph, eager, eager, graph),
   20 steps each (10 for se), read back once, printed on the ``FUSED``
   line;
5h. the fused step with ``compute_dtype='bfloat16'`` at full width, batch
   12, float32 banks, for vad v8, eff B0 v1 and se v9 pretrain: the
   graphed step against its plain version under cuDNN's deterministic
   algorithms, its heuristics' choice (2 steps, bit for bit or within
   two plain runs' gap), one launch a step; the float32 and the bfloat16 graphed steps of each
   model with their first call's peak, and timed
   in turns (float32, bfloat16, bfloat16, float32; ``fused_step_ms``
   against ``bf16_step_ms``, 10 steps a turn, 5 for se); and the density
   trainer's configuration in bfloat16 with ``grad_accum=2`` in banks
   mode, 2 plain and 2 graphed steps, two launches a step, with its
   peaks; printed on the ``BF16`` line with 4g's and 7f's results;
5i. bank rotation (``data/streaming.py``): the seed-0 sources at 4 times
   the count of phase 2 (128 backgrounds of 1,875 frames, 2,048 voices,
   512 noises) dealt into 4 chunks of pinned host banks, float32 and int8;
   on each chunk, swapped into the card's slot, the float32 and int8
   magnitude kernels against their plain versions, bit for bit; under
   cuDNN's deterministic algorithms, vad v8's graphed fused step streamed
   over two whole rotations (``chunk_steps`` 1, 8 steps, one float32
   launch a step) against the plain eager steps on the same rotation, at
   0.0 on every weight, BN statistic, Adam slot and metric; the upload of
   a chunk (``chunk_upload_ms``) and the swap's device copy
   (``swap_ms``) timed with CUDA events; and the resident graphed step
   (``fused_step_ms``) against the streamed one (``stream_step_ms``) at
   ``chunk_steps`` 4 and 1, in turns (resident, 4, 1, 1, 4, resident), 16
   steps a turn, with each loop's first-call peak and the memory it holds
   after, above what was held before it; printed on the ``STREAM`` line;
5j. resume on the card: under cuDNN's deterministic algorithms, vad v8 in
   banks mode with SWA and ``TrainStateCheckpoint`` for 4 epochs of 5
   steps; the same stopped after 2 epochs, restored
   (``restore_train_state``) into a fresh loop and run for epochs 2-3:
   weights, BN statistics, Adam's slots, lr and step, and the SWA average
   equal the uninterrupted run's at 0.0; then that checkpoint restored
   into the uninterrupted loop, whose graph is captured, and epochs 2-3
   replayed: equal again. Once on resident banks and once streamed
   (``chunk_steps`` 3, so the resume lands mid-rotation); then
   ``ckpt_save_ms`` and ``ckpt_restore_ms`` of vad v8 and of the density
   model at the trainer's defaults (17,564,315 parameters);
5k. the data-parallel mesh (``parallel/``): two ranks share the card over
   gloo, this process rank 0 and a child rank 1 (``parallel.launch``),
   with vad v8 at full width and batch 12, 6 a rank. One SGD step of
   ``make_sharded_train_step`` on a fixed global batch against the
   one-process step on it (loss rtol 1e-5, every weight and BN statistic
   rtol 1e-4 / atol 1e-6, JAX's bounds in tests/test_parallel.py); 3
   fused mesh steps on replicated float32 banks and 3 on ``--bank_shard``
   int8 banks (each rank its block), one ``synth_mag_f32`` or
   ``synth_mag_int8`` launch a step in each rank, the ranks'
   ``state_dict``s equal bit for bit after them; the fused mesh step and
   the one-process eager step timed in turns (mesh, one, one, mesh) on
   the float32 banks: two ranks on one card, not a speed measurement;
   ``evaluate(mesh=)`` on a 6 x 60 s dev set, each rank a block of each
   chunk's clips, its grids and ERs equal to the one-process batched
   eval's on both ranks; then ``utils.profiling.trace`` around two
   graphed vad v8 steps, writing a non-empty trace, with ``StepTimer``
   around each, its step within 10% of phase 5g's ``fused_step_ms``;
   printed on the ``MESH`` line;
5m. the mesh steps as CUDA graphs over NCCL: a mesh of one rank on this
   card (``parallel.launch``, no child), and of two ranks on two cards
   where two are visible. Each rank, for vad v8 and eff B0 v1 at full
   width and batch 12, under cuDNN's deterministic algorithms, runs each
   mesh step graphed and through ``.plain`` from one seed, 3 calls each:
   ``make_sharded_train_step`` and ``make_sharded_eval_step`` on fixed
   global batches, the fused train step on replicated float32 banks
   (one ``synth_mag_f32`` a step) and on ``--bank_shard`` int8 banks
   with ``grad_accum`` 2 and ``steps_per_call`` 4 (2 calls, one
   ``synth_mag_int8`` a microbatch), the fused eval step (one
   ``synth_mag_f32`` a call): every weight, BN statistic, optimizer slot
   and metric equal at 0.0, one capture a step object, the launches
   counted from the graphs' replays, and the first call's collectives
   (``Mesh._flat``) the eager step's, then the same recorded by the
   capture on the capturing stream, a backward's (autograd's thread)
   among them; ``TrainLoop.fit`` for 2 epochs of 3 steps and 1
   validation step on the mesh, through one capture of each step; then
   the graphed mesh step, its ``.plain`` and the one-process graphed
   step in turns (``mesh_graph_step_ms``, ``mesh_eager_step_ms``,
   ``fused_step_ms``, 10 steps a turn). With two ranks, their states
   after each run and their logs equal bit for bit. Printed on the
   ``MESH_GRAPH`` line;
5l. graphed iterator and validation steps (``train/state.py``
   ``TrainStep``, ``EvalStep``; ``train/graph.py``): the density trainer's
   defaults (on the 2,048-frame float32 banks, its loss with the l2
   penalty, AdaBelief), vad v8 and eff B0 v1 (the registered
   stochastic-depth generator) at full width through ``TrainLoop.fit`` over
   ``DevicePipeline``, under cuDNN's deterministic algorithms, graphed and
   plain (``.plain``) from one seed: the capture's step and 2 replays, a
   validation capture and 1 replay, then ``set_weights`` (the weights
   halved, in place), a step, ``save_train_state``, a step,
   ``restore_train_state``, a step and a validation step; every weight,
   BN statistic, optimizer slot and step count and every logged value
   equal at 0.0, one capture a step object (no recapture), one
   ``synth_mag_f32`` a batch; then graphed against eager in turns (graph,
   eager, eager, graph), 10 steps each with the pipeline, as ``fit`` runs
   them (``iter_step_ms``, ``eager_iter_step_ms``). The graphed
   ``FusedEvalStep`` of vad v8 against its plain version from one seed,
   3 calls, at 0.0, one launch captured and 3 counted, and timed in turns
   (``fused_eval_ms``, ``eager_fused_eval_ms``). ``mixture.sample_batch``
   on float32, bfloat16 and int8 banks in both layouts, magnitude mode and
   the se triple at the main path's batch: each route's kernel launched
   once (``check_launches``) and its output equal to the plain version's
   at 0.0. Printed on the ``ITER`` line;
6. times: each kernel and its plain version in turns (plain, kernel,
   kernel, plain) with CUDA events, their bounds from this run's draws
   (the se triple's: its sources read once, three windows written), the
   launch of an empty kernel (PyTorch's spin kernel for 0 cycles) timed
   the same way, and the vad training
   step (20 steps of one epoch, read back once, as ``fit`` does), the
   batch pipeline and the model step on their own; the same for the se
   pretrain step (10 steps); then the vad training step in banks mode, as
   the CLI runs it (the graphed fused step), and the batch pipeline alone, with float32 and int8
   banks in turns (float32, int8, int8, float32), so that only the bank
   dtype differs; the mel kernels against their plain versions in turns,
   with bounds over the band's columns and over all columns; the v9
   fused-mel training step (``v9_step_ms``, 20 steps); and the batch
   pipeline through B1 and the matmul mel (``pipeline_ms``) and through B4
   (``fused_mel_pipeline_ms``) in turns (unfused, fused, fused, unfused);
   the eff B0 v1 step (``eff_step_ms``, 20 steps of one epoch), its batch
   pipeline and model step, and B7 v6's step (``eff_b7_step_ms``, 5 steps,
   timed right after its run in 5e so that its memory is freed before the
   later phases), printed on the ``EFF`` line with the peaks of 5e;
7. the CLI chain, in a temporary directory (``cli.sj_train`` trains in
   banks mode, so through the graphed fused step, whose replays count the
   launches they replay): the realistic spec sets as
   pickles under sj_train's default file names, and a dev set of 6
   two-channel 16 kHz WAVs of 60 s with ``sample_answer.json``; then
   ``cli.sj_train.main`` with ``--bank_dtype int8`` for 3 epochs of 5 steps
   (16 validation steps each; the eval callback fires at epoch 2 and SWA
   folds at epoch 1), which must launch the int8 kernel once per batch (63
   times) and write the checkpoint trio and a 3-row CSV; ``cli.eval.main``
   with ``--p``, which must return 6 finite ERs; and ``--bank_dtype
   bfloat16`` for 1 epoch of 5 steps, which must launch the bfloat16
   kernel 21 times. Each run's counts are set to 0 just before it and read
   just after. The eval seconds of the 6 x 60 s dev set are timed;
8. the same ``_SWA.h5`` evaluated on the card and on the CPU over 2 of the
   clips cut to 8 s. The briefly trained model predicts no event, so its
   BN statistics are first set to those of the clips and its output bias
   shifted per class until a tenth of the CPU's output frames over both
   clips lie above 0.5. The smoothed scores must
   agree within 1e-5 of their peak, the 0/1 grids must hold both events
   and silence, any frame whose grid differs must have a score within
   1e-5 of 0.5 (the count of such frames is printed), and the ERs against
   the answers inside each clip's 8 s must be identical;
7b. the se CLI chain in that directory: ``cli.sj_train.main`` with
   ``--model_type se --v 9 --pretrain True --bank_dtype int8`` for 3
   epochs of 2 steps (16 validation steps each), which must launch the
   int8 se triple kernel once a batch (54 times) and write the trio
   under the run name ending ``_weight``; that checkpoint copied to the
   finetune run's name, which the finetune run loads (the reference's
   bool flag reads any ``--pretrain`` value as True, so it is left out);
   the finetune run with ``--bank_dtype bfloat16`` for the same epochs,
   54 bfloat16 launches, its trio, and a U-Net bit-identical to the
   pretrain checkpoint's; then ``cli.eval.main`` on the finetuned
   ``_SWA.h5``, which must return 6 finite ERs, timed;
7c. the channel maps' CLI chain in that directory: ``cli.sj_train.main``
   with ``--model_type vad --v 9 --n_chan 3 --bank_dtype int8`` for 3
   epochs of 2 steps (16 validation steps each), which must launch the
   int8 flat-complex kernel once a batch (54 times) and write the trio;
   ``cli.eval.main --p`` on it, and ``evaluate()`` with the n_chan 4 model
   of 5d and an n_chan 1 model from ``get_model``, 6 finite ERs each;
7d. the eff CLI chain in that directory: ``cli.sj_train.main`` with
   ``--model_type eff --model 0 --v 1 --bank_dtype int8`` for 3 epochs of
   2 steps (16 validation steps each), which must launch the int8
   magnitude kernel once a batch (54 times) and write the trio and a
   3-row CSV; ``cli.eval.main --p`` on it, timed (``eff_eval_s``), and
   ``evaluate()`` with a B0 v5 model, which scores its coarse grid (8
   frames a window), 6 finite ERs each;
7e. the density trainer's CLI chain in that directory:
   ``cli.trainer.main`` at its defaults with ``--n_chan 2 --bank_dtype
   int8`` for 3 epochs of 2 steps (16 validation steps each), which must
   launch the int8 magnitude kernel once a batch (54 times) and write
   ``{name}.h5``, ``{name}_SWA.h5`` and a 3-row ``{name}.log`` of cos_sim
   and val_cos_sim; then the same name with ``--pretrain True`` for 2
   epochs (36 launches), which loads ``{name}.h5`` and cuts the learning
   rate on plateaus instead of the warmup schedule; both timed;
7f. the bfloat16 CLI chain in that directory: ``cli.sj_train.main`` with
   vad v8, ``--compute_dtype bfloat16 --bank_dtype int8`` for 3 epochs of
   5 steps (63 int8 launches), its float32 trio, ``cli.eval.main --p
   --compute_dtype bfloat16`` (6 finite ERs); one epoch each of ``--loss
   focal --optimizer sgd`` and ``--loss MSE --mse_multiplier 8
   --optimizer rmsprop`` (21 float32 launches each, a finite loss, moved
   weights); ``cli.trainer.main --compute_dtype bfloat16`` at its
   defaults with ``--n_chan 2 --bank_dtype int8`` for 2 epochs of 1 step
   (34 int8 launches; one epoch raises ``NO_SWA_ERROR``, as in JAX), its
   float32 ``{name}.h5`` and ``_SWA.h5``;
7g. the long-run CLI chain in that directory: ``cli.sj_train.main`` with
   vad v8, ``--bank_dtype int8 --stream_chunks 2 --chunk_steps 2
   --ckpt_dir D --ckpt_every_epochs 1`` for 2 epochs of 5 steps (42 int8
   launches, full-state checkpoints at steps 5 and 10), then the same with
   ``--epochs 3 --resume True``, which must print JAX's resume line, train
   epoch 3 only (21 launches) and leave the trio and a 3-row CSV; and
   ``cli.trainer.main`` at its defaults with ``--n_chan 2 --grad_accum 2
   --ckpt_dir D2`` for 2 epochs of 1 step (36 float32 launches), then
   ``--resume True --epochs 3`` (18), resumed from step 2;
7h. Keras checkpoints, ``torch.export`` artifacts and the batched eval,
   in a directory of their own beside the dev set: the ``H5PY`` line
   (h5py's version, or null; then also ``KERAS {"h5py": null}``);
   ``cli.sj_train.main`` vad v8 on int8 banks for 8 epochs of 5 steps
   (168 int8 launches and no other kernel, through the graphed step; 8
   epochs, as ``get_csv_data`` below evaluates a run whose log has more
   than ``--patience`` + 5 lines), with ``--keras_ckpt True`` where h5py
   imports; each file of the trio made to predict events as in phase 8
   and written back, then ``cli.eval --p`` on it (Keras files: HDF5, with
   the ERs and grids of ``torch.save`` copies; one Keras save and load
   timed); ``export_infer`` of full-width vad v8 and v9, reloaded
   from bytes with the module deleted, equal to the module at batch 2 and
   8 (a 60 s clip's windows) under cuDNN's deterministic algorithms (or
   within 1e-5 of the peak, the gap printed), its forward timed against
   the module's in turns; ``export_eval`` of the run's best weights, made
   to predict events as in phase 8, whose grids equal
   ``evaluate(batched=True)``'s and, on the valid rows, the per-clip
   path's, with equal ERs, the three timed in turns after a warm-up
   turn; the batched eval's peak memory per PCM byte for vad v8 and v9,
   se v9 and eff B0 v1 and B7 v6; and ``cli.get_csv_data`` on the run's
   directory: one row, the trio's ERs at overlap_hop 256.

The last lines are the card's name and power limit as nvidia-smi gives
them, one JSON object ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import gc
import glob
import hashlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import wave
from unittest import mock

import numpy as np
import torch

from challenge_tpu_torch import (
    Config, DevicePipeline, TrainLoop, build_banks, get_model)
from challenge_tpu_torch.cli import eval as eval_cli
from challenge_tpu_torch.cli import sj_train, trainer
from challenge_tpu_torch.data import mixture
from challenge_tpu_torch.data.labels import (
    label_downsample, speech_enhancement_preprocess)
from challenge_tpu_torch.data.pipeline import FeatureFn
from challenge_tpu_torch.data.specset import FLAT_DTYPES
from challenge_tpu_torch.data.streaming import (
    StreamingBanks, bank_tensors, build_streaming_banks)
from challenge_tpu_torch.evaluate import events, infer
from challenge_tpu_torch.models.layers import BatchNorm, set_compute_dtype
from challenge_tpu_torch.models.registry import ModelBundle, get_density_model
from challenge_tpu_torch.models.senet import SECascade
from challenge_tpu_torch.models.vad import VADModel
from challenge_tpu_torch.ops import cuda
from challenge_tpu_torch.ops import synth as synth_lib
from challenge_tpu_torch.ops.augment import batch_mask_keep
from challenge_tpu_torch.ops.dsp import load_wav
from challenge_tpu_torch.ops.synth import (
    FLAT_KERNELS, KERNELS, MEL_KERNELS, SE_KERNELS, se_triple_args,
    synthesize_flat, synthesize_flat_plain, synthesize_magnitude,
    synthesize_magnitude_plain, synthesize_mel, synthesize_mel_plain,
    synthesize_se, synthesize_se_plain)
from challenge_tpu_torch.train import SWA, TrainStateCheckpoint
from challenge_tpu_torch.train.checkpoint import (
    checkpoint_steps, load_weights, restore_train_state, save_train_state,
    save_weights, train_state_tensors)
from challenge_tpu_torch.train.losses import binary_crossentropy, se_loss
from challenge_tpu_torch.parallel import (
    Mesh, current, launch, make_fused_eval_step, make_fused_train_step,
    make_sharded_eval_step, make_sharded_train_step, replicate, shard_banks,
    shard_batch)
from challenge_tpu_torch.utils import profiling
from challenge_tpu_torch.train.optim import make_optimizer
from challenge_tpu_torch.train.state import (
    TrainState, init_state, make_grad_update, make_train_step)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TRAIN_STEPS, VAL_STEPS = 5, 1
SE_STEPS, SE_VAL_STEPS = 3, 1      # each se phase of 5b
SE_TIMED_STEPS = 10                # phase 6's se step
CLI_EPOCHS, CLI_STEPS, CLI_VAL_STEPS = 3, 5, 16
SE_CLI_STEPS = 2                   # phase 7b, per epoch
EFF_STEPS, EFF_VAL_STEPS = 5, 1    # phase 5e's B0 v1 run
EFF_HEAD_STEPS = 2                 # the other heads and B7 in 5e
EFF_B7_TIMED_STEPS = 5             # B7 v6's step time, right after its run
DENSITY_STEPS, DENSITY_VAL_STEPS = 5, 1    # phase 5f through kernel B1
DENSITY_FUSED_STEPS = 2                    # then through kernel B4
DENSITY_TIMED_STEPS = 10                   # its step time, right after
DENSITY_PRETRAIN_EPOCHS = 2                # phase 7e's second run
BF16_TIMED_STEPS = 10                      # phase 5h, each turn (se: 5)
STREAM_CHUNKS = 4                          # phases 5i, 5j
STREAM_TIMED_STEPS = 16                    # phase 5i, each turn
RESUME_EPOCHS, RESUME_STEPS, RESUME_STOP = 4, 5, 2     # phase 5j
MESH_SIZE, MESH_STEPS, MESH_TIMED_STEPS = 2, 3, 5      # phase 5k
MESH_TIMER_TOL = 0.10          # phase 5k: StepTimer against fused_step_ms
MESH_GRAPH_CALLS = 3           # phase 5m: each step's calls, graphed and plain
MESH_GRAPH_INT8 = (2, 4, 2)    # phase 5m, int8: calls, steps_per_call,
                               # grad_accum
MESH_GRAPH_EPOCHS, MESH_GRAPH_FIT_STEPS = 2, 3     # phase 5m's fit
MESH_GRAPH_TIMED_STEPS = 10    # phase 5m, each turn
ITER_STEPS, ITER_VAL_STEPS = 2, 1      # phase 5l, beyond each capture
ITER_TIMED_STEPS = 10                  # phase 5l, each turn
SR = 16000
CUT_S = 8                      # phase 8's clips, seconds
SCORE_TOL = 1e-5               # phase 8: card vs CPU, times the peak
DENSITY_GRAD_TOL = 2e-5        # phase 4f: gradients to float64, times the
                               # peak (the CPU's float32 reads 9.7e-6)
DENSITY_LEAF_TOL = 5e-5        # phase 4f: each tensor's, times its own
                               # peak (the CPU's float32 reads 2.0e-5)
DENSITY_LEAF_FLOOR = 1e-6      # phase 4f: tensors held to their own peak
DENSITY_STEP_ULPS = 4.0        # phase 4f: AdaBelief against float64
MIN_GAP = 1e-3                 # phase 8: least logit gap at the threshold
SHARP = 8.0                    # phase 8: logits next to the threshold, after
                               # scaling (sigmoid(-8) = 3.4e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def sources(seed: int, n_bg: int, bg_len, n_voice: int, voice_len,
            n_noise: int, noise_len):
    """Random [257, T, 4] float32 spectrograms and 30-class voice labels,
    made in bulk from one numpy generator. A length is an int or an
    inclusive (lo, hi) range."""
    rng = np.random.default_rng(seed)

    def lengths(n, spec):
        if isinstance(spec, int):
            return [spec] * n
        return rng.integers(spec[0], spec[1] + 1, n).tolist()

    def specs(n, spec, scale):
        ls = lengths(n, spec)
        block = rng.standard_normal((257, sum(ls), 4), dtype=np.float32)
        block *= scale
        ends = np.cumsum(ls)
        return [block[:, e - t:e] for t, e in zip(ls, ends)]

    return (specs(n_bg, bg_len, 1.0), specs(n_voice, voice_len, 0.5),
            rng.integers(0, 30, n_voice), specs(n_noise, noise_len, 0.3))


def max_abs_diff(args, flat: bool = False) -> float:
    """Max abs difference of a synthesis kernel (the magnitude one, or the
    flat-complex one) and its plain version on ``args``."""
    if flat:
        out, ref = synthesize_flat(*args), synthesize_flat_plain(*args)
    else:
        out = synthesize_magnitude(*args)
        ref = synthesize_magnitude_plain(*args)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f'kernel {out.shape} {out.dtype}, plain '
                             f'{ref.shape} {ref.dtype}')
    return float((out.float() - ref.float()).abs().max())


def se_diff(args) -> float:
    """Max abs difference of an se triple kernel's three outputs and the
    plain version's (the three plain flat-complex calls of
    ``se_triple_args``), and of them and the three single-call kernels."""
    outs, refs = synthesize_se(*args), synthesize_se_plain(*args)
    singles = [synthesize_flat(*a) for a in se_triple_args(*args)]
    torch.cuda.synchronize()
    diff = 0.0
    for out, ref, single in zip(outs, refs, singles):
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f'kernel {out.shape} {out.dtype}, plain '
                                 f'{ref.shape} {ref.dtype}')
        diff = max(diff, float((out.float() - ref.float()).abs().max()),
                   float((out.float() - single.float()).abs().max()))
    return diff


def adversarial_cases(dev):
    """Synthesis arguments that probe the kernel's edges, made with numpy:
    negative shifts and shifts of n_frame and past it, w == 0 slots, clips
    longer than their stated length after short ones in the same slot, a
    lens past the bank's rows, no noise bank, and n_frame not a multiple
    of the kernel's row tile; and misaligned ranges: background windows at
    odd row offsets and clip banks of 13 and 25 rows (odd item strides), so
    that the staged row ranges start at every residue mod 16 bytes that
    the element size allows (multiples of 4 for int8 rows of 1028 columns;
    every even residue at 514 columns, one complex channel, whose F/2 = 257
    is odd), at batch 6 and batch 1. float32 banks; see
    :func:`lowp_case`."""
    rng = np.random.default_rng(11)
    f = 4 * 257

    def bank(n, rows, lens=None, width=f):
        x = rng.standard_normal((n, rows, width)).astype(np.float32)
        if lens is not None:
            for i, t in enumerate(lens):
                x[i, t:] = 0.0
        return torch.from_numpy(x).to(dev)

    def ints(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=dev)

    def floats(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    cases = {}
    nf, b = 61, 3
    vw = rng.uniform(0.1, 1, (b, 4))
    vw[0, 1] = vw[2, 0] = 0.0
    nw = rng.uniform(0.1, 1, (b, 2))
    nw[1, 1] = 0.0
    cases['edges'] = (
        nf, bank(2, 80), ints([0, 1, 1]), ints([0, 7, 19]),
        bank(3, 24), ints(rng.integers(0, 3, (b, 4))),
        ints([[nf, -23, 0, nf - 1], [-24, 100, 5, -3], [2, 2, -200, 60]]),
        floats(vw), bank(2, 12), ints(rng.integers(0, 2, (b, 2))),
        ints([[-11, 0], [nf - 4, 9], [nf, -12]]), floats(nw),
        ints([[24, 30, 10, 24], [1, 24, 24, 7], [24, 3, 24, 24]]), None)
    lens = [96, 20, 50, 96]
    cases['long_then_short'] = (
        64, bank(2, 128), ints([0, 1]), ints([3, 40]),
        bank(4, 96, lens), ints([[0, 1, 2], [3, 2, 1]]),
        ints(rng.integers(-10, 64, (2, 3))),
        floats(rng.uniform(0.5, 1, (2, 3))),
        None, None, None, None, ints(np.asarray(lens)[[[0, 1, 2], [3, 2, 1]]]),
        None)
    for name, nf, b, width, boff in (('misaligned', 45, 6, f, range(1, 7)),
                                     ('misaligned_b1', 29, 1, f, [3]),
                                     ('half_odd', 33, 4, f // 2,
                                      [1, 2, 3, 5])):
        n_bg, n_v, n_x = 3, 6, 5
        cases[name] = (
            nf, bank(n_bg, 77, width=width), ints(np.arange(b) % n_bg),
            ints(list(boff)), bank(n_v, 13, width=width),
            ints(rng.integers(0, n_v, (b, 5))),
            ints(rng.integers(-12, nf, (b, 5))),
            floats(rng.uniform(0.1, 1, (b, 5))), bank(n_x, 25, width=width),
            ints(rng.integers(0, n_x, (b, 2))),
            ints(rng.integers(-20, nf, (b, 2))),
            floats(rng.uniform(0.1, 1, (b, 2))),
            ints(rng.integers(5, 16, (b, 5))),
            ints(rng.integers(9, 30, (b, 2))))
    return cases


def lowp_case(args, dtype: torch.dtype):
    """A float32 adversarial case with its banks rounded to bfloat16, or
    quantized per item to int8 with the clip scales folded into the
    weights and the background scales passed, as the int8 banks are."""
    (nf, bg, bidx, boff, vb, vidx, vshift, vw, nb, nidx, nshift, nw,
     vlens, nlens) = args

    def quantize(bank):
        peak = bank.abs().amax(dim=(1, 2))
        scale = torch.where(peak > 0, peak / 127.0, torch.ones_like(peak))
        q = torch.clamp(torch.round(bank / scale[:, None, None]), -127, 127)
        return q.to(torch.int8), scale

    if dtype == torch.bfloat16:
        return (nf, bg.to(dtype), bidx, boff, vb.to(dtype), vidx, vshift, vw,
                None if nb is None else nb.to(dtype), nidx, nshift, nw,
                vlens, nlens, None)
    (bg, bs), (vb, vs) = quantize(bg), quantize(vb)
    vw = vw * vs[vidx.long()]
    if nb is not None:
        nb, ns = quantize(nb)
        nw = nw * ns[nidx.long()]
    return (nf, bg, bidx, boff, vb, vidx, vshift, vw, nb, nidx, nshift, nw,
            vlens, nlens, bs[bidx.long()])


def synth_work(d, width: int, dtype: torch.dtype, flat: bool = False,
               outputs: int = 1):
    """(bytes, flops) that synthesizing the draws ``d`` from banks of
    ``dtype`` needs, counting what this run's data needs: each sample's
    background window, the rows of every active clip (w != 0) that land in
    the window, the slot tables (and int8's background scales) and the
    output written, each once (the magnitude, F/2 columns, or with
    ``flat`` the complex window, F columns; ``outputs`` such windows for
    the se triple, which reads its sources once); a multiply and an add
    per clip element (and an add per clip element into its sub-mix for the
    triple), int8's background scaling, and 3 operations and a root per
    magnitude."""
    elem = torch.empty((), dtype=dtype).element_size()
    out_elem = torch.empty((), dtype=KERNELS[dtype][1]).element_size()
    n_frame, b = d.n_frame, d.bidx.shape[0]
    rows, table = 0, 2 * b * 4
    for shift, w, lens in ((d.vshift, d.vw, d.vlens),
                           (d.nshift, d.nw, d.nlens)):
        if shift is None:
            continue
        lo = (-shift).clamp(min=0)
        hi = torch.minimum(lens, n_frame - shift)
        rows += int(((hi - lo).clamp(min=0) * (w != 0)).sum())
        table += 4 * shift.numel() * 4
    window = b * n_frame * width
    out = outputs * b * n_frame * (width if flat else width // 2)
    nbytes = elem * (window + rows * width) + out_elem * out + table
    flops = (2 + (outputs > 1)) * rows * width + (0 if flat else 4 * out)
    if dtype == torch.int8:
        nbytes += 4 * b
        flops += window
    return nbytes, flops


def mel_work(d, width: int, dtype: torch.dtype, band, n_mels: int,
             all_columns: bool = False):
    """(bytes, flops) that the fused mel kernel needs on the draws ``d``:
    each sample's background window and the rows of every active clip
    that land in it, over the band's columns only (re and im of both
    channels at rows f_lo .. f_lo + n_f - 1; ``all_columns`` counts all
    F columns, the dense mel matrix and the full column mask instead), the
    slot tables, the masks, the band and the mel and min/max written,
    each once; a multiply and an add per clip element, 3 operations, a
    root and the mask per magnitude, a multiply and an add per nonzero mel
    product and the time mask per output."""
    elem = torch.empty((), dtype=dtype).element_size()
    n_frame, b = d.n_frame, d.bidx.shape[0]
    cols = width if all_columns else 4 * band.n_f
    rows, table = 0, 2 * b * 4
    for shift, w, lens in ((d.vshift, d.vw, d.vlens),
                           (d.nshift, d.nw, d.nlens)):
        if shift is None:
            continue
        lo = (-shift).clamp(min=0)
        hi = torch.minimum(lens, n_frame - shift)
        rows += int(((hi - lo).clamp(min=0) * (w != 0)).sum())
        table += 4 * shift.numel() * 4
    window = b * n_frame * cols
    nnz = band.row.numel()
    freq = width // 4
    masks = 4 * b * (n_frame + cols // 2)
    band_bytes = (4 * freq * n_mels if all_columns
                  else 4 * (n_mels + 1) + 8 * nnz)
    out = b * n_frame * n_mels * 2
    nbytes = (elem * (window + rows * cols) + table + masks + band_bytes
              + 4 * out + 8 * b)
    products = freq * n_mels if all_columns else nnz
    flops = (2 * rows * cols + 5 * window // 2
             + 2 * b * n_frame * 2 * products + out)
    if dtype == torch.int8:
        nbytes += 4 * b
        flops += window
    return nbytes, flops


def mel_diff(args, melm, tmask, fmask) -> float:
    """Max abs difference of a mel kernel and its plain version on
    ``args``, over the mel and the min/max."""
    kw = dict(melm=melm, tmask=tmask, fmask=fmask)
    (mel, mm), (ref, ref_mm) = (synthesize_mel(*args, **kw),
                                synthesize_mel_plain(*args, **kw))
    torch.cuda.synchronize()
    for a, r in ((mel, ref), (mm, ref_mm)):
        if a.shape != r.shape or a.dtype != r.dtype or a.dtype != \
                torch.float32:
            raise AssertionError(f'kernel {a.shape} {a.dtype}, plain '
                                 f'{r.shape} {r.dtype}')
    return max(float((mel - ref).abs().max()),
               float((mm - ref_mm).abs().max()))


def random_masks(b: int, nf: int, cols: int, seed: int, dev,
                 zero_sample=None):
    """{0,1} float32 time masks [b, nf] and column masks [b, cols] made
    with numpy; ``zero_sample`` masks every frame of that sample."""
    rng = np.random.default_rng(seed)
    tmask = (rng.random((b, nf)) > 0.2).astype(np.float32)
    fmask = (rng.random((b, cols)) > 0.2).astype(np.float32)
    if zero_sample is not None:
        tmask[zero_sample] = 0.0
    return (torch.from_numpy(tmask).to(dev), torch.from_numpy(fmask).to(dev))


def draws_head(d, n: int):
    """The first ``n`` samples of the draws ``d``."""
    return mixture.Draws(d.n_frame, *(None if x is None else x[:n]
                                      for x in d[1:]))


def mel_checks(dev, banks, main_draws, cases, banks2048) -> dict:
    """Phase 3d: each mel kernel against its plain version, mel and
    min/max, on the main path's draws with training masks, eval masks
    (all ones) and the filter columns, on batch 1, on a sample whose time
    mask zeroes every frame, on the adversarial cases (rounded or
    quantized for the low-precision banks), on draws at 40 and 128 mel
    bins, 500 frames and batch 48, and on the density trainer's batch
    (12 x 2,048 frames, its training masks without filter columns) from
    ``banks2048``, built for 2,048 frames."""
    cfg = Config(model_type='vad', v=9, name='filter')
    fn = FeatureFn(cfg, device=dev, fused_mel=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    draw_gen = torch.Generator(device=dev).manual_seed(4)
    errs = {}
    for name, dt in FLAT_DTYPES.items():
        e = dict.fromkeys(('main_train', 'main_eval', 'main_filter',
                           'batch1', 'masked_sample'), 0.0)
        for d in main_draws[:3]:
            args = mixture.synth_args(banks[name], d)
            tmask, fmask = fn.masks(gen)
            fmask = fmask.repeat(1, 2)
            ones = (torch.ones_like(tmask), torch.ones_like(fmask))
            e['main_train'] = max(e['main_train'],
                                  mel_diff(args, fn.melm, tmask, fmask))
            e['main_eval'] = max(e['main_eval'], mel_diff(args, fn.melm,
                                                          *ones))
            e['main_filter'] = max(e['main_filter'], mel_diff(
                args, fn.melm, tmask, fmask * fn.filter_cols))
            one = mixture.synth_args(banks[name], draws_head(d, 1))
            e['batch1'] = max(e['batch1'], mel_diff(one, fn.melm, tmask[:1],
                                                    fmask[:1]))
            zero = tmask.clone()
            zero[3] = 0.0
            e['masked_sample'] = max(e['masked_sample'], mel_diff(
                args, fn.melm, zero, fmask))
            _, mm = synthesize_mel(*args, melm=fn.melm, tmask=zero,
                                   fmask=fmask)
            if mm[3].tolist() != [0.0, 0.0] or not bool((mm[:3, 1] > 0).all()):
                raise AssertionError(f'min/max of a masked sample: {mm}')
        for i, (case, args) in enumerate(cases.items()):
            args = (args + (None,) if dt == torch.float32
                    else lowp_case(args, dt))
            tmask, fmask = random_masks(args[2].shape[0], args[0],
                                        args[1].shape[-1] // 2, i, dev,
                                        zero_sample=0)
            e[case] = mel_diff(args, fn.melm, tmask, fmask)
        # the design's edges: 40 mel bins (up to 11 band rows a bin) and
        # 128, each with its own band; 500 frames, not a multiple of the
        # row tile; 48 samples, more work items than one wave of blocks
        for case, kw in (('mels40', dict(n_mels=40)),
                         ('mels128', dict(n_mels=128)),
                         ('frames500', dict(n_frame=500)),
                         ('batch48', dict(batch_size=48))):
            c = Config(model_type='vad', v=9, **kw)
            f = FeatureFn(c, device=dev, fused_mel=True)
            d = mixture.draw(draw_gen, banks['float32'], c.batch_size,
                             c.n_frame, max_voices=c.max_voices,
                             max_noises=c.max_noises, snr=c.snr)
            tmask, fmask = f.masks(gen)
            e[case] = mel_diff(mixture.synth_args(banks[name], d), f.melm,
                               tmask, fmask.repeat(1, 2))
        c = density_config()
        f = FeatureFn(c, device=dev, fused_mel=True, variant='density')
        d = mixture.draw(draw_gen, banks2048['float32'], c.batch_size,
                         c.n_frame, max_voices=c.max_voices,
                         max_noises=c.max_noises, snr=c.snr)
        tmask, fmask = f.masks(gen)
        e['density2048'] = mel_diff(mixture.synth_args(banks2048[name], d),
                                    f.melm, tmask, fmask.repeat(1, 2))
        errs[MEL_KERNELS[dt]] = e
    return errs


def feature_iter(banks, cfg, training: bool = True, fused_mel: bool = True,
                 variant: str = 'sj'):
    """Batches of ``FeatureFn(cfg, training, fused_mel=..., variant=...)``
    drawn with a ``torch.Generator`` seeded as ``DevicePipeline`` seeds
    its own."""
    fn = FeatureFn(cfg, training, fused_mel=fused_mel, variant=variant)
    gen = torch.Generator(device=fn.device)
    gen.manual_seed(cfg.seed + (0 if training else 1))
    while True:
        yield fn(gen, banks)


def check_launches(what: str, launches: dict, expected: dict) -> None:
    log(f'{what} launches: {json.dumps(launches)}')
    if launches != expected:
        raise AssertionError(f'{what}: launches {launches}, expected '
                             f'{expected}')


def mel_main_path(banks) -> dict:
    """Phase 5c: vad v9 at full width through ``FeatureFn(fused_mel=True)``
    on float32 banks, ``TrainLoop.fit`` for 5 training steps and 1
    validation step; then v6 and v7 for 2 steps each on the same path, and
    v9 for 2 steps each on bfloat16 and int8 banks. Each run's counts are
    set to 0 just before it and read just after: the mel kernel of the
    banks' dtype must have run once a batch and no other kernel. Returns
    the v9 loop and its iterator for phase 6, and the results."""
    res = {'mel_launches': {}}      # per run, 'v9_float32', ...
    out = None
    for v, name, steps, val_steps in (
            (9, 'float32', TRAIN_STEPS, VAL_STEPS), (6, 'float32', 2, 0),
            (7, 'float32', 2, 0), (9, 'bfloat16', 2, 0), (9, 'int8', 2, 0)):
        cfg = Config(model_type='vad', v=v)
        loop = TrainLoop(get_model(cfg))
        n_params = sum(p.numel() for p in loop.state.module.parameters())
        train_it = feature_iter(banks[name], cfg)
        val_it = feature_iter(banks[name], cfg, training=False)
        cuda.reset_launch_counts()
        hist = loop.fit(train_it, epochs=1, steps_per_epoch=steps,
                        validation_iter=val_it if val_steps else None,
                        validation_steps=val_steps, verbose=0)
        torch.cuda.synchronize()
        kernel = MEL_KERNELS[FLAT_DTYPES[name]]
        launches = dict(cuda.LAUNCHES)
        check_launches(f'vad v{v} fused mel, {name} banks', launches,
                       {kernel: steps + val_steps})
        res['mel_launches'][f'v{v}_{name}'] = launches
        logs = hist[0]
        if not all(math.isfinite(x) for k, x in logs.items() if k != 'time'):
            raise AssertionError(f'vad v{v} {name}: non-finite logs {logs}')
        res[f'v{v}_{name}'] = dict(params=n_params, loss=logs['loss'],
                                   val_loss=logs.get('val_loss'))
        if out is None:
            out = loop, train_it
    return out + (res,)


def chan_main_path(banks) -> dict:
    """Phase 5d: full-width vad v8 with n_chan 3 on bfloat16 banks and 4 on
    float32 banks through ``DevicePipeline``'s complex branch, 2 steps
    each, the flat-complex kernel of the banks' dtype once a batch; and
    n_chan 1, whose features keep 2 channels and whose training raises the
    port's ValueError. Returns the n_chan 4 model for phase 7c, and the
    results."""
    res = {'chan_launches': {}}
    model = None
    for n_chan, name in ((3, 'bfloat16'), (4, 'float32'), (1, 'float32')):
        cfg = Config(model_type='vad', v=8, n_chan=n_chan)
        bundle = get_model(cfg)
        it = iter(DevicePipeline(banks[name], cfg))
        if n_chan == 1:
            x, _ = next(it)
            if x.shape[-1] != 2 or bundle.input_shape[-1] != 1:
                raise AssertionError(f'n_chan 1: features {tuple(x.shape)}')
            try:
                TrainLoop(bundle).fit(it, epochs=1, steps_per_epoch=1,
                                      verbose=0)
            except ValueError as e:
                if 'mono_chan' not in str(e):
                    raise
                log(f'n_chan 1: 2-channel features; training raises: {e}')
            else:
                raise AssertionError('n_chan 1 training did not raise')
            continue
        loop = TrainLoop(bundle)
        x, _ = next(it)
        if x.shape[-1] != n_chan or bundle.input_shape[-1] != n_chan:
            raise AssertionError(f'n_chan {n_chan}: features '
                                 f'{tuple(x.shape)}')
        cuda.reset_launch_counts()
        hist = loop.fit(it, epochs=1, steps_per_epoch=2, verbose=0)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        check_launches(f'vad v8 n_chan {n_chan}, {name} banks', launches,
                       {FLAT_KERNELS[FLAT_DTYPES[name]]: 2})
        res['chan_launches'][n_chan] = launches
        if not math.isfinite(hist[0]['loss']):
            raise AssertionError(f'n_chan {n_chan}: loss {hist[0]}')
        res[f'chan{n_chan}_loss'] = hist[0]['loss']
        model = bundle.module
    return model, res


def mel_reference_check(dev) -> dict:
    """Phase 4d: the card against the CPU on a small input (batch 4, 80
    mels, 64 frames): the fused-mel kernel's mel and min/max and the labels
    bit for bit on the same draws and masks, the log-mel features within 2
    float32 ulps (the log rounds on each device's own libm); then one
    training-mode forward and loss of full-width vad v6, v7 and v9, the
    card's float32 held to a float64 CPU copy within ``SCORE_TOL`` of each
    output's peak or 10 times the CPU float32's distance (phase 8's
    rule)."""
    cpu = torch.device('cpu')
    cfg = Config(model_type='vad', v=9, n_frame=64, batch_size=4)
    src = sources(3, 3, (20, 90), 6, (10, 40), 3, (8, 20))
    banks = {d: build_banks(*src, n_frame=64, device=d) for d in (cpu, dev)}
    draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 4, 64)
    gdraws = mixture.Draws(*(x.to(dev) if torch.is_tensor(x) else x
                             for x in draws))
    fns = {d: FeatureFn(cfg, device=d, fused_mel=True) for d in (cpu, dev)}
    tmask, fmask = fns[cpu].masks(torch.Generator().manual_seed(6))
    fmask = fmask.repeat(1, 2)
    out = {}
    for d, dr in ((cpu, draws), (dev, gdraws)):
        (mel, mm), y = mixture.synthesize_mel(banks[d], dr, fns[d].melm,
                                              tmask.to(d), fmask.to(d))
        x, y = fns[d].fused_features(mel, mm, y)
        out[d] = [t.cpu() for t in (mel, mm, y, x)]
    for c, g in zip(out[cpu][:3], out[dev][:3]):
        if not torch.equal(c, g):
            raise AssertionError('card vs CPU fused mel: max diff '
                                 f'{float((g - c).abs().max())}')
    xc, xg = out[cpu][3], out[dev][3]
    ulp = torch.nextafter(xc.abs(), torch.tensor(float('inf'))) - xc.abs()
    if not bool(((xg - xc).abs() <= 2 * ulp).all()):
        raise AssertionError('card vs CPU fused log-mel beyond 2 ulps')
    res = {'fused_logmel_bit_equal': bool(torch.equal(xc, xg))}
    gaps = {}
    for v in (6, 7, 9):
        m_c = get_model(Config(model_type='vad', v=v, n_frame=64),
                        device=cpu, seed=v).module
        models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
                  'f64': copy.deepcopy(m_c).double()}
        r = {}
        with torch.no_grad():
            for key, m in models.items():
                where = dev if key == 'card' else cpu
                dt = torch.float64 if key == 'f64' else torch.float32
                o = m.train()(xc.to(where, dt))
                r[key] = torch.cat([o.double().cpu().flatten(),
                                    binary_crossentropy(
                                        out[cpu][2].to(where, dt),
                                        o).double().cpu().reshape(1)])
        gaps[f'v{v}'] = {k: float((r[k] - r['f64']).abs().max()
                                  / r['f64'].abs().max())
                         for k in ('cpu', 'card')}
        if gaps[f'v{v}']['card'] > max(SCORE_TOL,
                                       10 * gaps[f'v{v}']['cpu']):
            raise AssertionError(f'card vad v{v} forward beyond the '
                                 f'tolerance: {gaps}')
    log('card vs CPU fused mel, small input: mel, min/max and labels '
        f'equal, log-mel bit-equal {res["fused_logmel_bit_equal"]}; v6, v7, '
        f'v9 forward and loss gaps to float64 over the peak '
        f'{json.dumps(gaps)}')
    return dict(res, version_forward_gaps=gaps)


def chan_cli_chain(d: str, n_chan4_model) -> dict:
    """Phase 7c, in the CLI chain's directory ``d``: ``cli.sj_train`` with
    vad v9, n_chan 3 and int8 banks for 3 epochs of 2 steps, the int8
    flat-complex kernel once a batch; its trio; ``cli.eval --p``; then
    ``evaluate()`` on the same dev set with the n_chan 4 model of phase 5d
    and an n_chan 1 model from ``get_model``."""
    res = {}
    batches = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    run, res['chan3_launches'], res['chan3_cli_s'] = run_cli(
        ['--model_type', 'vad', '--v', '9', '--n_chan', '3', '--datapath', d,
         '--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
         '--steps_per_epoch', str(SE_CLI_STEPS)], 'synth_flat_int8', batches)
    res['chan3_cli_batches'] = batches
    check_trio(run)
    ers = {'chan3_cli': eval_cli.main(['--name', run, '--p'])}
    for n_chan, module in ((4, n_chan4_model),
                           (1, get_model(Config(model_type='vad', v=9,
                                                n_chan=1)).module)):
        ers[f'chan{n_chan}'] = infer.evaluate(
            Config(model_type='vad', v=8 if n_chan == 4 else 9,
                   n_chan=n_chan), module)
    torch.cuda.synchronize()
    for k, e in ers.items():
        if len(e) != 6 or not all(map(math.isfinite, e)):
            raise AssertionError(f'{k} ERs: {e}')
    log(f'n_chan eval, 6 x 60 s: ERs {json.dumps(ers)}')
    res['chan_ers'] = ers
    return res


def fix_keep_masks(module, x, gen) -> None:
    """Draw each stochastic-depth block's keep mask for the batch ``x``
    once from the CPU generator ``gen``, and make the block use it in every
    training forward, on any device (a deep copy keeps it)."""
    for block in module.backbone.blocks:
        if block.drop_rate > 0:
            mask = block.keep_mask(x, gen)
            block.keep_mask = lambda x, gen, m=mask: m.to(x.device)


def eff_reference_check(dev) -> dict:
    """Phase 4e: the eff family on the card against the CPU on a small
    input (batch 2, B0, 40 mels, 256 frames): one training-mode forward and
    BCE loss of each head (v1, v3, v5, v6, v7) with the same keep masks on
    every copy, the card's float32 held to a float64 CPU copy within
    ``SCORE_TOL`` of each output's peak or 10 times the CPU float32's
    distance (phase 8's rule)."""
    cpu = torch.device('cpu')
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 40, 256, 2),
                                             dtype=np.float32))
    gaps = {}
    for v in (1, 3, 5, 6, 7):
        cfg = Config(model_type='eff', v=v, n_mels=40, n_frame=256)
        m_c = get_model(cfg, device=cpu, seed=v).module
        fix_keep_masks(m_c, x, torch.Generator().manual_seed(v))
        models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
                  'f64': copy.deepcopy(m_c).double()}
        frames = {1: 256, 5: 256 * 256 // 16000}.get(v, 256 // 32)
        y = torch.from_numpy((rng.random((2, frames, 3)) < 0.5)
                             .astype(np.float32))
        r = {}
        with torch.no_grad():
            for key, m in models.items():
                where = dev if key == 'card' else cpu
                dt = torch.float64 if key == 'f64' else torch.float32
                o = m.train()(x.to(where, dt), torch.Generator(device=where))
                r[key] = torch.cat([o.double().cpu().flatten(),
                                    binary_crossentropy(
                                        y.to(where, dt), o).double().cpu()
                                    .reshape(1)])
        gaps[f'v{v}'] = {k: float((r[k] - r['f64']).abs().max()
                                  / r['f64'].abs().max())
                         for k in ('cpu', 'card')}
        if gaps[f'v{v}']['card'] > max(SCORE_TOL,
                                       10 * gaps[f'v{v}']['cpu']):
            raise AssertionError(f'card eff v{v} forward beyond the '
                                 f'tolerance: {gaps}')
    log('card vs CPU eff B0, small input: forward and loss gaps to float64 '
        f'over the peak {json.dumps(gaps)}')
    return {'eff_forward_gaps': gaps}


def eff_main_path(banks) -> tuple:
    """Phase 5e: the eff family at full width (80 mels, 512 frames, batch
    12, n_chan 2) on float32 banks through ``get_model``,
    ``DevicePipeline`` and ``TrainLoop.fit``: B0 v1 (the ``sj_train``
    defaults) for 5 training steps and 1 validation step, then B0 v3, v5,
    v6 and v7 and B7 v6 for 2 steps each, and B7 v6's step time over 5
    more. Each run's counts are set to 0 just before it and read just
    after: the float32 magnitude kernel must have run once a batch and no
    other kernel, every logged value must be finite, and the epoch's
    dropout generator must have been drawn (stochastic depth ran on the
    card). Returns the B0 v1 loop and its iterator for phase 6, and the
    results."""
    kernel = KERNELS[torch.float32][0]
    res = {'eff_launches': {}}
    out = None
    for model, v, steps, val_steps in (
            (0, 1, EFF_STEPS, EFF_VAL_STEPS), (0, 3, EFF_HEAD_STEPS, 0),
            (0, 5, EFF_HEAD_STEPS, 0), (0, 6, EFF_HEAD_STEPS, 0),
            (0, 7, EFF_HEAD_STEPS, 0), (7, 6, EFF_HEAD_STEPS, 0)):
        name = f'B{model}_v{v}'
        cfg = Config(model_type='eff', model=model, v=v)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loop = TrainLoop(get_model(cfg))
        n_params = sum(p.numel() for p in loop.state.module.parameters())
        train_it = iter(DevicePipeline(banks, cfg))
        val_it = iter(DevicePipeline(banks, cfg, training=False))
        cuda.reset_launch_counts()
        hist = loop.fit(train_it, epochs=1, steps_per_epoch=steps,
                        validation_iter=val_it if val_steps else None,
                        validation_steps=val_steps, verbose=0)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        check_launches(f'eff {name}', launches, {kernel: steps + val_steps})
        res['eff_launches'][name] = launches
        logs = hist[0]
        if not all(math.isfinite(x) for k, x in logs.items() if k != 'time'):
            raise AssertionError(f'eff {name}: non-finite logs {logs}')
        if torch.equal(loop.gen.get_state(), loop.dropout_gen(0).get_state()):
            raise AssertionError(f'eff {name}: stochastic depth drew nothing')
        # the run's peak above what the earlier phases hold
        res[name] = dict(params=n_params, loss=logs['loss'],
                         val_loss=logs.get('val_loss'),
                         peak_gib=(torch.cuda.max_memory_allocated() - base)
                         / 2**30)
        if model == 7:
            res['eff_b7_step_ms'] = wall_ms(lambda: loop.run_epoch(
                train_it, EFF_B7_TIMED_STEPS, training=True),
                1) / EFF_B7_TIMED_STEPS
        if out is None:
            out = loop, train_it
        del loop, train_it, val_it
    log(f'eff main path: {json.dumps(res)}')
    return out + (res,)


def eff_cli_chain(d: str) -> dict:
    """Phase 7d, in the CLI chain's directory ``d``: ``cli.sj_train`` with
    ``--model_type eff --v 1 --bank_dtype int8`` (B0) for 3 epochs of 2
    steps, the int8 magnitude kernel once a batch; its trio and CSV;
    ``cli.eval --p``, timed; then ``evaluate()`` with a B0 v5 model on its
    coarse grid."""
    res = {}
    start = time.perf_counter()
    batches = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    run, res['eff_int8_launches'], res['eff_int8_cli_s'] = run_cli(
        ['--model_type', 'eff', '--model', '0', '--v', '1', '--datapath', d,
         '--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
         '--steps_per_epoch', str(SE_CLI_STEPS)], 'synth_mag_int8', batches)
    res['eff_cli_batches'] = batches
    check_trio(run)
    with open(run + '.csv') as f:
        rows = f.read().strip().splitlines()
    if len(rows) != 1 + CLI_EPOCHS:
        raise AssertionError(f'{run}.csv has {len(rows)} lines')
    t0 = time.perf_counter()
    ers = {'eff_v1_cli': eval_cli.main(['--name', run, '--p'])}
    torch.cuda.synchronize()
    res['eff_eval_s'] = time.perf_counter() - t0
    v5 = Config(model_type='eff', v=5)
    ers['eff_v5'] = infer.evaluate(v5, get_model(v5).module)
    torch.cuda.synchronize()
    for k, e in ers.items():
        if len(e) != 6 or not all(map(math.isfinite, e)):
            raise AssertionError(f'{k} ERs: {e}')
    log(f'eff eval, 6 x 60 s: ERs {json.dumps(ers)}, the CLI\'s in '
        f'{res["eff_eval_s"]:.3f} s')
    res['eff_ers'] = ers
    log(f'phase 7d: {time.perf_counter() - start:.3f} s')
    return res


class Tee(io.StringIO):
    """A text buffer that also writes everything to ``stream``."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)


def fused_run(bundle, banks, spc: int, calls: int, graphed: bool,
              state=None, step=None, seed: int = 11):
    """``calls`` calls of the fused step of ``bundle`` (``steps_per_call``
    ``spc``) on ``banks``, graphed or its plain version, from a fresh
    state of seed 0 and generators of ``seed``. Returns (state, step,
    per-call metrics, generators): a graphed step replays with the state,
    banks and generators of its capture (others capture anew)."""
    dev = bundle.device
    if state is None:
        state = init_state(bundle, 0)
        step = make_fused_train_step(bundle, bundle.config,
                                     steps_per_call=spc)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dgen = (torch.Generator(device=dev).manual_seed(seed + 1)
            if bundle.needs_dropout_gen else None)
    run = step if graphed else step.plain
    metrics = [run(state, banks, gen, dgen) for _ in range(calls)]
    torch.cuda.synchronize()
    return state, step, metrics, (gen, dgen)


def fused_record(state, metrics) -> dict:
    """Everything a step leaves: weights, BN statistics, Adam's moments
    and step count, and the metrics of each call, cloned."""
    rec = {f'w.{k}': v.detach().clone()
           for k, v in state.module.state_dict().items()}
    names = {id(p): n for n, p in state.module.named_parameters()}
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            rec[f'{k}.{names[id(p)]}'] = v.clone()
    rec['step'] = state.optimizer.param_groups[0]['step'].clone()
    for i, m in enumerate(metrics):
        rec.update({f'metric{i}.{k}': v.detach().clone()
                    for k, v in m.items()})
    return rec


def fused_gap(a: dict, b: dict):
    """(the largest absolute difference over two records' tensors, the
    tensor where it lies)."""
    if set(a) != set(b):
        raise AssertionError(f'records differ in keys: {set(a) ^ set(b)}')
    gaps = [(float((a[k].double() - b[k].double()).abs().max())
             if a[k].numel() else 0.0, k) for k in a]
    return max(gaps)


def hold(what: str, gap, spread) -> None:
    """Bit for bit, or within two plain runs' own gap where they already
    differ."""
    log(f'fused {what}: gap {gap}, plain runs {spread}')
    if gap[0] > spread[0]:
        raise AssertionError(f'{what}: gap {gap} beyond the plain runs\' '
                             f'{spread}')


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms only (``cudnn.benchmark`` still
    picks among them): two plain runs of one seed then agree bit for bit,
    where the default algorithms' atomics part them."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def fused_triple(cfg, banks, spc: int, steps: int = 4,
                 search: bool = True):
    """Two plain runs and one graphed run of ``steps`` steps of ``cfg``
    from one seed: (records, the graphed run's launches, (bundle, state,
    step, generators) of the graphed run). ``search=False`` runs the
    steps with ``cudnn.benchmark`` off, cuDNN's heuristic choice of
    algorithm instead of its timed search."""
    recs = []
    for graphed in (False, False, True):
        bundle = get_model(cfg)
        state = init_state(bundle, 0)
        step = make_fused_train_step(bundle, cfg, steps_per_call=spc)
        cuda.reset_launch_counts()
        # after the entry points, which turn it on
        torch.backends.cudnn.benchmark = search
        try:
            state, step, metrics, gens = fused_run(
                bundle, banks, spc, steps // spc, graphed, state, step)
        finally:
            torch.backends.cudnn.benchmark = True
        recs.append(fused_record(state, metrics))
    return recs, dict(cuda.LAUNCHES), (state, step, gens)


def steady_peak(bundle, banks, step=None):
    """2 plain steps of ``bundle`` (``steps_per_call`` 2), then 2 graphed
    ones: (state, the graphed call's metrics, the peak device memory in
    GiB above what was held before each call: (plain, graphed)). cuDNN's
    algorithm search tries workspaces of tens of GiB at a convolution's
    first call, and remat's recompute calls some convolutions anew, so
    the plain steps' peak holds that search and the graphed call's does
    not."""
    state = init_state(bundle, 0)
    if step is None:
        step = make_fused_train_step(bundle, bundle.config,
                                     steps_per_call=2)
    peaks = []
    for graphed in (False, True):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, _, metrics, _ = fused_run(bundle, banks, 2, 1, graphed, state,
                                     step)
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
    return state, metrics, peaks


def fused_checks(banks, banks2048) -> dict:
    """Phase 5g: the fused step (``parallel/train.py``) at full width,
    batch 12, on float32 banks, for vad v8, eff B0 v1 (stochastic depth)
    and se v9 pretrain. With cuDNN's deterministic algorithms: the graphed
    step against its plain version from the same seed (4 steps: weights,
    BN statistics, Adam's moments and step, the metrics), bit for bit,
    two plain runs' gap printed beside; the launches of the graphed call,
    its replays included; for vad v8 and eff B0 v1 ``steps_per_call=4``
    against 4 calls of 1, ``grad_accum=2`` graphed against its plain
    version (2 steps each), and ``remat`` against none (2 plain steps,
    then 2 graphed), bit for bit, with the peaks of ``steady_peak``.
    With the default algorithms, as the CLI runs: the gap of two plain
    runs and of the graph to the first, printed; the density trainer's
    configuration (B4 at 2,048 frames, ``grad_accum=2``) in banks mode
    with and without remat, with their peaks; and the graphed and the
    eager step timed in turns (graph, eager, eager, graph), 20 steps each
    (10 for se), read back once."""
    start = time.perf_counter()
    res = {}
    for name, cfg, spc in (
            ('vad_v8', Config(model_type='vad', v=8), 4),
            ('eff_b0_v1', Config(model_type='eff', model=0, v=1), 4),
            ('se_v9', Config(model_type='se', v=9, pretrain=True), 2)):
        t0 = time.perf_counter()
        r = res[name] = {}
        kernel = ('synth_se_f32' if name == 'se_v9'
                  else KERNELS[torch.float32][0])
        with cudnn_deterministic():
            recs, launches, _ = fused_triple(cfg, banks, spc)
            check_launches(f'fused {name}', launches, {kernel: 4})
            r['spread'] = fused_gap(recs[0], recs[1])
            r['graph_gap'] = fused_gap(recs[0], recs[2])
            hold(f'{name} graph vs plain', r['graph_gap'], r['spread'])
            if name != 'se_v9':
                # steps_per_call 4 against 4 calls of 1, both graphed
                state, _, metrics, _ = fused_run(get_model(cfg), banks, 1,
                                                 4, True)
                single = fused_record(state, [])
                mean = {f'metric0.{k}': torch.stack(
                    [m[k] for m in metrics]).mean(0) for k in metrics[0]}
                del state
                four = {k: v for k, v in recs[2].items()
                        if not k.startswith('metric')}
                r['steps_per_call_gap'] = fused_gap(four, single)
                hold(f'{name} steps_per_call 4 vs 4 x 1',
                     r['steps_per_call_gap'], r['spread'])
                hold(f'{name} steps_per_call 4 vs 4 x 1, metrics',
                     fused_gap({k: v for k, v in recs[2].items()
                                if k.startswith('metric')}, mean),
                     r['spread'])
                # grad_accum 2, graphed against plain, 2 steps
                acc, launches, _ = fused_triple(
                    cfg.replace(grad_accum=2), banks, 2, 2)
                check_launches(f'fused {name} grad_accum 2', launches,
                               {kernel: 4})
                r['grad_accum_spread'] = fused_gap(acc[0], acc[1])
                r['grad_accum_gap'] = fused_gap(acc[0], acc[2])
                hold(f'{name} grad_accum 2 graph vs plain',
                     r['grad_accum_gap'], r['grad_accum_spread'])
                # remat against no remat, 2 plain steps then 2 graphed;
                # the peak of the graphed call
                rm = []
                for remat in (False, True):
                    bundle = get_model(cfg.replace(remat=remat))
                    state, metrics, peaks = steady_peak(bundle, banks)
                    r[f'peak_gib_remat_{remat}'] = peaks
                    rm.append(fused_record(state, metrics))
                    del bundle, state, metrics
                r['remat_gap'] = fused_gap(rm[0], rm[1])
                hold(f'{name} remat vs none', r['remat_gap'], r['spread'])
        # the default algorithms, as the CLI runs: gaps printed; then the
        # graphed and the eager step timed in turns
        recs, _, (state, step, (gen, dgen)) = fused_triple(cfg, banks, spc)
        weights = [{k: v for k, v in rec.items() if k.startswith('w.')}
                   for rec in recs]
        r['default_spread'] = fused_gap(recs[0], recs[1])
        r['default_graph_gap'] = fused_gap(recs[0], recs[2])
        r['default_weight_spread'] = fused_gap(weights[0], weights[1])
        r['default_weight_gap'] = fused_gap(weights[0], weights[2])
        log(f'fused {name}, default algorithms: graph vs plain '
            f'{r["default_graph_gap"]}, plain runs {r["default_spread"]}; '
            f'weights {r["default_weight_gap"]}, '
            f'{r["default_weight_spread"]}')
        n = 10 if name == 'se_v9' else 20
        r['fused_step_ms'], r['eager_fused_step_ms'] = [], []
        for graphed in (True, False, False, True):
            run = step if graphed else step.plain
            r['fused_step_ms' if graphed else 'eager_fused_step_ms'].append(
                wall_ms(lambda: run(state, banks, gen, dgen), n // spc)
                / spc)
        del state, step, recs, weights
        r['seconds'] = time.perf_counter() - t0
        log(f'fused {name}: {json.dumps(r)}')
    # the density trainer's configuration: B4 at 2,048 frames, grad_accum
    # 2, through banks mode, with and without remat
    t0 = time.perf_counter()
    ns = density_args(['--grad_accum', '2'])
    dens = []
    for remat in (False, True):
        cfg = trainer.to_config(ns).replace(remat=remat)
        bundle = get_density_model(cfg, seed=cfg.seed)
        step = make_fused_train_step(bundle, cfg, trainer.make_loss_fn(ns),
                                     variant='density', steps_per_call=2)
        state, metrics, res[f'density_peak_gib_remat_{remat}'] = \
            steady_peak(bundle, banks2048, step)
        if not all(math.isfinite(float(v)) for v in metrics[0].values()):
            raise AssertionError(f'density remat {remat}: {metrics}')
        dens.append(fused_record(state, metrics))
        del bundle, state, step
    res['density_remat_gap'] = fused_gap(dens[0], dens[1])
    res['density_s'] = time.perf_counter() - t0
    res['fused_5g_s'] = time.perf_counter() - start
    log(f'phase 5g: {res["fused_5g_s"]:.3f} s')
    return res


def bf16_fused_checks(banks, banks2048) -> dict:
    """Phase 5h: the fused step (``parallel/train.py``) at full width,
    batch 12, on float32 banks, with ``compute_dtype='bfloat16'``, for vad
    v8, eff B0 v1 and se v9 pretrain. With cuDNN's deterministic algorithms, chosen by
    its heuristics (its timed search of the bfloat16 engines under the
    deterministic flag took 51 of 5h's 90 s on an NVIDIA H100 80GB HBM3
    at 700.00 W): the graphed step against its plain
    version from one seed (2 steps, one graphed call: the eager step, the
    capture and a replay), bit for bit or within two plain runs' gap,
    and the graphed call's launches, one a step. With the default
    algorithms: the float32 and the bfloat16
    graphed step of the model, each from its first call (the eager step
    with cuDNN's algorithm search, the capture, the replays), with the
    peak device memory of that first call above what was held before it
    (``peak_gib``), then timed in turns (float32,
    bfloat16, bfloat16, float32), ``BF16_TIMED_STEPS`` steps each (half
    for se). Then the density trainer's configuration with ``grad_accum``
    2 in bfloat16 on 2,048-frame banks, 2 plain and 2 graphed steps, two
    magnitude launches a step."""
    start = time.perf_counter()
    res = {}
    for name, cfg, spc in (
            ('vad_v8', Config(model_type='vad', v=8), 2),
            ('eff_b0_v1', Config(model_type='eff', model=0, v=1), 2),
            ('se_v9', Config(model_type='se', v=9, pretrain=True), 2)):
        t0 = time.perf_counter()
        r = res[name] = {}
        kernel = ('synth_se_f32' if name == 'se_v9'
                  else KERNELS[torch.float32][0])
        bcfg = cfg.replace(compute_dtype='bfloat16')
        with cudnn_deterministic():
            recs, launches, _ = fused_triple(bcfg, banks, spc, steps=2,
                                             search=False)
            check_launches(f'bf16 fused {name}', launches, {kernel: 2})
            r['launches'] = launches
            r['spread'] = fused_gap(recs[0], recs[1])
            r['graph_gap'] = fused_gap(recs[0], recs[2])
            hold(f'bf16 {name} graph vs plain', r['graph_gap'], r['spread'])
            del recs
        r['deterministic_s'] = time.perf_counter() - t0
        runs = {}
        for dt, c in (('float32', cfg), ('bfloat16', bcfg)):
            t1 = time.perf_counter()
            bundle = get_model(c)
            state = init_state(bundle, 0)
            step = make_fused_train_step(bundle, c, steps_per_call=spc)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, _, metrics, gens = fused_run(bundle, banks, spc, 1, True,
                                            state, step)
            if not math.isfinite(float(metrics[0]['loss'])):
                raise AssertionError(f'bf16 fused {name} {dt}: {metrics}')
            # the first call's peak: the eager step with cuDNN's search,
            # the capture, the replays
            r[f'{dt}_peak_gib'] = (torch.cuda.max_memory_allocated()
                                   - base) / 2**30
            r[f'{dt}_first_call_s'] = time.perf_counter() - t1
            runs[dt] = (state, step, gens)
        n = BF16_TIMED_STEPS // (2 if name == 'se_v9' else 1)
        r['fused_step_ms'], r['bf16_step_ms'] = [], []
        for dt in ('float32', 'bfloat16', 'bfloat16', 'float32'):
            state, step, gens = runs[dt]
            r['bf16_step_ms' if dt == 'bfloat16' else 'fused_step_ms'].append(
                wall_ms(lambda: step(state, banks, *gens), n // spc) / spc)
        del runs, state, step
        r['seconds'] = time.perf_counter() - t0
        log(f'bf16 fused {name}: {json.dumps(r)}')
    # the density trainer's configuration in bfloat16: B4 at 2,048 frames,
    # grad_accum 2, banks mode
    ns = density_args(['--grad_accum', '2', '--compute_dtype', 'bfloat16'])
    cfg = trainer.to_config(ns)
    bundle = get_density_model(cfg, seed=cfg.seed)
    step = make_fused_train_step(bundle, cfg, trainer.make_loss_fn(ns),
                                 variant='density', steps_per_call=2)
    cuda.reset_launch_counts()
    _, metrics, res['density_peak_gib'] = steady_peak(bundle, banks2048, step)
    torch.cuda.synchronize()
    res['density_launches'] = dict(cuda.LAUNCHES)
    check_launches('bf16 density grad_accum 2', res['density_launches'],
                   {KERNELS[torch.float32][0]: 8})
    if not all(math.isfinite(float(v)) for v in metrics[0].values()):
        raise AssertionError(f'bf16 density: {metrics}')
    del bundle, step
    res['bf16_5h_s'] = time.perf_counter() - start
    log(f'phase 5h: {res["bf16_5h_s"]:.3f} s')
    return res


def banks_gib(banks) -> float:
    return sum(t.numel() * t.element_size()
               for t in bank_tensors(banks)) / 2**30


def copy_tensors(dsts, srcs) -> None:
    for d, s in zip(dsts, srcs):
        d.copy_(s, non_blocking=True)


def stream_run(cfg, sb, steps: int, graphed: bool, seed: int = 11):
    """``steps`` calls of vad's fused step (one step a call) on the
    rotation ``sb``, from a fresh state of seed 0 and a generator of
    ``seed``, graphed or its plain version: (state, per-call metrics, the
    launches, counted from 0)."""
    bundle = get_model(cfg)
    state = init_state(bundle, 0)
    step = make_fused_train_step(bundle, cfg, steps_per_call=1)
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    run = step if graphed else step.plain
    cuda.reset_launch_counts()
    metrics = [run(state, sb.next_banks(), gen) for _ in range(steps)]
    torch.cuda.synchronize()
    return state, metrics, dict(cuda.LAUNCHES)


def stream_checks(dev, resident) -> tuple:
    """Phase 5i: bank rotation at 4 times phase 2's sources, 4 chunks. On
    each chunk in the card's slot, B1 and B3-int8 against their plain
    versions at 0.0; the graphed streamed step over two rotations against
    the plain one at 0.0 (cuDNN's deterministic algorithms); the upload,
    the swap and the streamed step against the resident one, timed.
    Returns (results, the pinned float32 chunks, for phase 5j)."""
    start = time.perf_counter()
    res = {}
    src = sources(0, 4 * 32, 1875, 4 * 512, (40, 130), 4 * 128, (20, 100))
    sbs = {name: build_streaming_banks(*src, n_chunks=STREAM_CHUNKS,
                                       n_frame=512, flat_dtype=name,
                                       chunk_steps=4)
           for name in ('float32', 'int8')}
    del src
    res['build_s'] = time.perf_counter() - start
    res['chunk_gib'] = {k: banks_gib(sb.chunks[0]) for k, sb in sbs.items()}
    res['set_gib'] = {k: sum(banks_gib(c) for c in sb.chunks)
                      for k, sb in sbs.items()}
    log(f'stream chunks: {json.dumps(res)}')
    cfg = Config(model_type='vad', v=8)
    f32 = KERNELS[torch.float32][0]
    # each chunk through the slot (a swap, after the first): its contents,
    # then each kernel against its plain version on draws from it
    errs = {}
    for name, sb in sbs.items():
        kernel = KERNELS[FLAT_DTYPES[name]][0]
        errs[kernel] = []
        for c in range(sb.n_chunks):
            sb.restore_cursor(c * sb.chunk_steps)
            banks = sb.peek()
            if not all(torch.equal(a, b.to(dev)) for a, b in
                       zip(bank_tensors(banks), bank_tensors(sb.chunks[c]))):
                raise AssertionError(f'{name} slot does not hold chunk {c}')
            gen = torch.Generator(device=dev).manual_seed(20 + c)
            for _ in range(2):
                d = mixture.draw(gen, banks, cfg.batch_size, cfg.n_frame,
                                 max_voices=cfg.max_voices,
                                 max_noises=cfg.max_noises, snr=cfg.snr)
                errs[kernel].append(max_abs_diff(mixture.synth_args(banks,
                                                                    d)))
    res['max_abs_err'] = {k: max(v) for k, v in errs.items()}
    log(f'stream kernel vs plain on each chunk: {json.dumps(errs)}')
    if any(v != 0.0 for v in res['max_abs_err'].values()):
        raise AssertionError('a kernel disagrees with its plain version on '
                             'chunk banks')
    chunks = sbs['float32'].chunks
    del sbs
    # the graphed streamed step against the plain one, two rotations
    steps = 2 * STREAM_CHUNKS
    with cudnn_deterministic():
        recs, launches = [], []
        for graphed in (False, False, True):
            sb = StreamingBanks(chunks, chunk_steps=1)
            state, metrics, counts = stream_run(cfg, sb, steps, graphed)
            if (sb.dispatches, sb.current_chunk) != (steps, 0):
                raise AssertionError(f'rotation at {sb.dispatches}, '
                                     f'{sb.current_chunk}')
            recs.append(fused_record(state, metrics))
            launches.append(counts)
            del state, sb
    res['spread'] = fused_gap(recs[0], recs[1])
    res['graph_gap'] = fused_gap(recs[0], recs[2])
    res['launches'] = launches[2]
    log(f'stream graph vs plain, two rotations: {res["graph_gap"]}, plain '
        f'runs {res["spread"]}')
    check_launches('stream graphed', launches[2], {f32: steps})
    if res['graph_gap'][0] != 0.0:
        raise AssertionError(f'streamed graph vs plain: {res["graph_gap"]}')
    del recs
    # a chunk's upload from pinned memory and the swap's device copy, on
    # the compute stream with CUDA events
    slot = [torch.empty_like(t, device=dev) for t in bank_tensors(chunks[0])]
    staged = [torch.empty_like(t) for t in slot]
    res['chunk_upload_ms'] = gpu_ms(
        copy_tensors, [(staged, bank_tensors(c)) for c in chunks], 8)
    res['swap_ms'] = gpu_ms(copy_tensors, [(slot, staged)], 16)
    nbytes = res['chunk_gib']['float32'] * 2**30
    res['upload_gb_s'] = nbytes / res['chunk_upload_ms'] / 1e6
    res['swap_bound_ms'] = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    del slot, staged
    # the resident graphed step against the streamed ones, in turns; each
    # loop's first call (the eager step, the capture, a replay) with its
    # peak and the memory it holds after, above what was held before it
    loops, res['peak_gib'], res['held_gib'] = {}, {}, {}
    for name, cs in (('resident', 0), ('chunk_steps_4', 4),
                     ('chunk_steps_1', 1)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loop = loops[name] = TrainLoop(get_model(cfg), banks=(
            StreamingBanks(chunks, chunk_steps=cs) if cs else resident))
        loop.run_epoch(None, 2, training=True, epoch=99)
        torch.cuda.synchronize()
        res['peak_gib'][name] = (torch.cuda.max_memory_allocated()
                                 - base) / 2**30
        res['held_gib'][name] = (torch.cuda.memory_allocated()
                                 - base) / 2**30
    times = {name: [] for name in loops}
    n = STREAM_TIMED_STEPS
    for name in ('resident', 'chunk_steps_4', 'chunk_steps_1',
                 'chunk_steps_1', 'chunk_steps_4', 'resident'):
        loop = loops[name]
        times[name].append(wall_ms(lambda: loop.run_epoch(
            None, n, training=True, epoch=0), 1) / n)
    res['fused_step_ms'] = times['resident']
    res['stream_step_ms'] = {k: v for k, v in times.items()
                             if k != 'resident'}
    del loops
    torch.cuda.empty_cache()
    res['stream_5i_s'] = time.perf_counter() - start
    log(f'phase 5i: {res["stream_5i_s"]:.3f} s')
    return res, chunks


def state_gap(want: dict, state) -> float:
    """The largest absolute difference of ``state``'s checkpointed tensors
    from ``want`` (``train_state_tensors`` cloned, with 'step' and
    'swa_count'); inf where the step or SWA count differ."""
    got = train_state_tensors(state)
    if set(got) != set(want) - {'step', 'swa_count'} or \
            (state.step, state.swa_count) != (want['step'],
                                              want['swa_count']):
        return math.inf
    return max(float((got[k].double() - want[k].double()).abs().max())
               if got[k].numel() else 0.0 for k in got)


def resume_checks(resident, chunks) -> dict:
    """Phase 5j: resume on the card, resident and streamed (chunk_steps 3),
    under cuDNN's deterministic algorithms; then the checkpoints timed."""
    start = time.perf_counter()
    res = {'launches': []}
    cfg = Config(model_type='vad', v=8)
    f32 = KERNELS[torch.float32][0]
    with cudnn_deterministic(), \
            tempfile.TemporaryDirectory(prefix='chip_smoke_ckpt_') as d:
        for mode in ('resident', 'streamed'):
            def make():
                banks = (resident if mode == 'resident'
                         else StreamingBanks(chunks, chunk_steps=3))
                return TrainLoop(get_model(cfg), banks=banks)

            def fit(loop, tag, initial=0, epochs=RESUME_EPOCHS):
                cuda.reset_launch_counts()
                loop.fit(epochs=epochs, steps_per_epoch=RESUME_STEPS,
                         verbose=0, initial_epoch=initial, callbacks=[
                             SWA(start_epoch=1, swa_freq=1, verbose=False),
                             TrainStateCheckpoint(
                                 os.path.join(d, f'{mode}_{tag}'), 1)])
                torch.cuda.synchronize()
                launches = dict(cuda.LAUNCHES)
                check_launches(f'resume {mode} {tag}', launches,
                               {f32: (epochs - initial) * RESUME_STEPS})
                res['launches'].append(launches)

            full = make()
            fit(full, 'full')
            want = {k: v.clone()
                    for k, v in train_state_tensors(full.state).items()}
            want.update(step=full.state.step, swa_count=full.state.swa_count)
            part = make()
            fit(part, 'part', epochs=RESUME_STOP)
            del part
            ckpt = os.path.join(d, f'{mode}_part')
            resumed = make()
            restore_train_state(ckpt, resumed.state)
            initial = (resumed.state.step
                       // resumed.steps_per_fused_epoch(RESUME_STEPS))
            if initial != RESUME_STOP:
                raise AssertionError(f'resumed at epoch {initial}')
            cursor = ((resumed.state.step // 3) % STREAM_CHUNKS,
                      resumed.state.step % 3) if mode == 'streamed' else None
            fit(resumed, 'resumed', initial)
            gap = state_gap(want, resumed.state)
            del resumed
            # into the loop whose graph is captured: the same addresses
            ptrs = {k: v.data_ptr()
                    for k, v in train_state_tensors(full.state).items()}
            restore_train_state(ckpt, full.state)
            moved = [k for k, v in train_state_tensors(full.state).items()
                     if v.data_ptr() != ptrs[k]]
            fit(full, 'replayed', initial)
            replay_gap = state_gap(want, full.state)
            del full
            res[mode] = dict(resumed_gap=gap, captured_graph_gap=replay_gap,
                             moved_tensors=moved, step=want['step'],
                             swa_count=want['swa_count'],
                             resume_cursor=cursor)
            log(f'resume {mode}: {json.dumps(res[mode])}')
            if gap != 0.0 or replay_gap != 0.0 or moved:
                raise AssertionError(f'resume {mode}: {res[mode]}')
        # the checkpoints timed: vad v8 and the density model
        for name, bundle in (('vad_v8', get_model(cfg)),
                             ('density', get_density_model(
                                 density_config(), seed=0))):
            state = init_state(bundle, 0)
            path = os.path.join(d, f'timed_{name}')
            save_train_state(path, state, step=1)
            restore_train_state(path, state)    # makes the optimizer's slots
            r = res[name] = dict(params=sum(
                p.numel() for p in bundle.module.parameters()),
                ckpt_save_ms=[], ckpt_restore_ms=[])
            for i in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_train_state(path, state, step=2 + i)
                r['ckpt_save_ms'].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                restore_train_state(path, state)
                torch.cuda.synchronize()
                r['ckpt_restore_ms'].append((time.perf_counter() - t0) * 1e3)
            r['ckpt_mb'] = os.path.getsize(os.path.join(
                path, str(4), 'train_state.pt')) / 1e6
            log(f'checkpoint {name}: {json.dumps(r)}')
            del bundle, state
    res['resume_5j_s'] = time.perf_counter() - start
    log(f'phase 5j: {res["resume_5j_s"]:.3f} s')
    return res


def state_digest(module) -> str:
    """A hash of every byte of ``module``'s weights and BN statistics."""
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def grids_digest(grids) -> list:
    return [hashlib.sha256(np.ascontiguousarray(g).tobytes()).hexdigest()
            for g in grids]


def mesh_banks(dtype: str, shard: bool, mesh):
    """Phase 5k's banks, built alike in every rank from one seed: on the
    rank's card, or with ``shard`` on the host and the rank's block of
    them copied to the card."""
    src = sources(7, 8, 1875, 64, (40, 130), 16, (20, 100))
    banks = build_banks(*src, n_frame=512, flat_dtype=dtype,
                        device='cpu' if shard else mesh.device)
    return shard_banks(banks, mesh) if shard else banks


def mesh_rank(args: dict) -> dict:
    """What each rank of phase 5k runs; rank 0 is this script's process,
    rank 1 a child that imports this module. Rank 0 returns the tensors
    it is held to, rank 1 their hashes."""
    mesh = current()
    dev = mesh.device
    out = {'rank': mesh.rank, 'backend': mesh.backend}
    # one SGD step of the sharded train step on the fixed global batch
    cfg = Config(model_type='vad', v=8, optimizer='sgd')
    bundle = get_model(cfg)
    state = TrainState(bundle.module, make_optimizer(
        cfg, bundle.module.parameters()))
    x, y = (torch.from_numpy(a).to(dev) for a in args['batch'])
    metrics = make_sharded_train_step(bundle, mesh)(
        state, shard_batch((x, y), mesh))
    out['sgd_loss'] = float(metrics['loss'])
    out['sgd_digest'] = state_digest(bundle.module)
    if mesh.rank == 0:
        out['sgd_state'] = {k: v.detach().clone()
                            for k, v in bundle.module.state_dict().items()}
    del bundle, state, x, y
    # 3 fused mesh steps on replicated float32 and sharded int8 banks
    for dtype, shard in (('float32', False), ('int8', True)):
        cfg = Config(model_type='vad', v=8, bank_dtype=dtype,
                     bank_shard=shard)
        banks = mesh_banks(dtype, shard, mesh)
        bundle = get_model(cfg)
        state = init_state(bundle, 0)
        replicate(state.module, mesh)
        step = make_fused_train_step(bundle, cfg, mesh=mesh,
                                     bank_sharded=shard)
        gen = torch.Generator(device=dev).manual_seed(20 + mesh.rank)
        cuda.reset_launch_counts()
        losses = [float(step(state, banks, gen)['loss'])
                  for _ in range(MESH_STEPS)]
        torch.cuda.synchronize()
        out[f'{dtype}_launches'] = dict(cuda.LAUNCHES)
        out[f'{dtype}_losses'] = losses
        out[f'{dtype}_digest'] = state_digest(bundle.module)
        out[f'{dtype}_voices'] = banks.voices.n
        if dtype == 'float32':
            # the mesh step and, on rank 0 alone, the one-process eager
            # step on the whole batch, in turns
            one = get_model(cfg)
            one_state = init_state(one, 0)
            one_step = make_fused_train_step(one, cfg)
            out['mesh_step_ms'], out['one_process_step_ms'] = [], []
            for which in ('mesh', 'one', 'one', 'mesh'):
                if which == 'mesh':
                    out['mesh_step_ms'].append(wall_ms(
                        lambda: step(state, banks, gen), MESH_TIMED_STEPS))
                elif mesh.rank == 0:
                    out['one_process_step_ms'].append(wall_ms(
                        lambda: one_step.plain(one_state, banks, gen),
                        MESH_TIMED_STEPS))
            del one, one_state, one_step
        del banks, bundle, state, step
    # the dev set over the mesh
    cfg = Config(model_type='vad', v=8)
    module = get_model(cfg).module
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in args['eval_weights'].items()})
    paths = sorted(glob.glob(os.path.join(args['dev'], '*.wav')))
    out['ers'] = infer.evaluate(cfg, module, eval_dir=args['dev'],
                                mesh=mesh)
    grids = infer.batched_grids(cfg, module, paths, mesh=mesh)
    out['grids'] = grids if mesh.rank == 0 else None
    out['grids_digest'] = grids_digest(grids)
    return out


def mesh_checks(dev, banks, fused_step_ms, d: str) -> dict:
    """Phase 5k: the data-parallel mesh, two ranks on this card over gloo
    (the module docstring); then ``utils.profiling`` around graphed vad v8
    steps. Raises where a rank fails or a check does not hold."""
    start = time.perf_counter()
    cfg = Config(model_type='vad', v=8, optimizer='sgd')
    x, y = FeatureFn(cfg, device=dev)(
        torch.Generator(device=dev).manual_seed(31), banks)
    # the one-process SGD step on the same global batch
    one = get_model(cfg)
    state = TrainState(one.module, make_optimizer(cfg,
                                                  one.module.parameters()))
    one_loss = float(make_train_step(one).plain(state, (x, y))['loss'])
    one_sd = {k: v.detach().clone()
              for k, v in one.module.state_dict().items()}
    del one, state
    # the eval model, made to fire on the dev set, and its one-process
    # grids and ERs
    ddir = os.path.join(d, 'mesh5k')
    os.makedirs(ddir)
    write_dev_set(ddir)
    paths = sorted(glob.glob(os.path.join(ddir, '*.wav')))
    ecfg = Config(model_type='vad', v=8)
    module = get_model(ecfg).module
    make_it_fire(ecfg, module, paths[:2])
    ers = infer.evaluate(ecfg, module, eval_dir=ddir)
    grids = infer.batched_grids(ecfg, module, paths)
    args = {'batch': (x.cpu().numpy(), y.cpu().numpy()),
            'eval_weights': {k: v.cpu().numpy()
                             for k, v in module.state_dict().items()},
            'dev': ddir}
    del module
    torch.cuda.empty_cache()
    # rank 0's arguments are not pickled: the one-process step's banks
    ranks = launch.run('chip_smoke:mesh_rank', (args,), [dev] * MESH_SIZE,
                       workdir=d)
    res = {'backends': [r['backend'] for r in ranks]}
    r0 = ranks[0]
    # 1. the sharded SGD step against the one-process step
    if not math.isclose(r0['sgd_loss'], one_loss, rel_tol=1e-5):
        raise AssertionError(f'mesh SGD loss {r0["sgd_loss"]} vs one '
                             f'process {one_loss}')
    worst = 0.0
    for k, want in one_sd.items():
        got = r0['sgd_state'][k]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f'mesh SGD {k}: {m}')
        worst = max(worst, float((got.double() - want.double()).abs()
                                 .max()))
    res['sgd_loss'] = [r0['sgd_loss'], one_loss]
    res['sgd_max_abs_diff'] = worst
    # 2. the fused mesh steps: one launch a step a rank, ranks identical
    for dtype, kernel in (('float32', 'synth_mag_f32'),
                          ('int8', 'synth_mag_int8')):
        res[f'{dtype}_launches'] = [r[f'{dtype}_launches'] for r in ranks]
        for r in ranks:
            check_launches(f'mesh {dtype} rank {r["rank"]}',
                           r[f'{dtype}_launches'], {kernel: MESH_STEPS})
            if not all(math.isfinite(v) for v in r[f'{dtype}_losses']):
                raise AssertionError(f'mesh {dtype}: {r[f"{dtype}_losses"]}')
        if len({r[f'{dtype}_digest'] for r in ranks}) != 1:
            raise AssertionError(f'mesh {dtype}: the ranks\' state_dicts '
                                 'differ')
        if len({tuple(r[f'{dtype}_losses']) for r in ranks}) != 1:
            raise AssertionError(f'mesh {dtype}: the ranks log different '
                                 'metrics')
        res[f'{dtype}_losses'] = r0[f'{dtype}_losses']
    res['int8_voices_a_rank'] = [r['int8_voices'] for r in ranks]
    if len({r['sgd_digest'] for r in ranks}) != 1:
        raise AssertionError('mesh SGD: the ranks\' state_dicts differ')
    res['mesh_step_ms'] = r0['mesh_step_ms']
    res['one_process_step_ms'] = r0['one_process_step_ms']
    # 3. the dev set over the mesh
    for r in ranks:
        if r['ers'] != ers:
            raise AssertionError(f'mesh eval rank {r["rank"]}: ERs '
                                 f'{r["ers"]} vs {ers}')
        if r['grids_digest'] != grids_digest(grids):
            raise AssertionError(f'mesh eval rank {r["rank"]}: grids differ')
    same_grids('mesh eval', r0['grids'], grids)
    res['ers'] = ers
    res['mesh_s'] = time.perf_counter() - start
    # 4. utils.profiling around graphed vad v8 steps
    t0 = time.perf_counter()
    bundle = get_model(Config(model_type='vad', v=8))
    state = init_state(bundle, 0)
    step = make_fused_train_step(bundle, bundle.config)
    gen = torch.Generator(device=dev).manual_seed(11)
    for _ in range(3):                    # capture, then replays
        step(state, banks, gen)
    tdir = os.path.join(d, 'trace5k')
    timer = profiling.StepTimer()
    with profiling.trace(tdir):
        for _ in range(2):
            with timer:
                timer.sync(step(state, banks, gen))
    files = [os.path.join(r, f) for r, _, fs in os.walk(tdir) for f in fs]
    sizes = [os.path.getsize(f) for f in files]
    if not sizes or min(sizes) == 0:
        raise AssertionError(f'trace wrote {files}, {sizes} bytes')
    summary = timer.summary()
    ref_ms = sum(fused_step_ms) / len(fused_step_ms)
    res['trace_files'] = [os.path.basename(f) for f in files]
    res['trace_bytes'] = sizes
    res['step_timer'] = summary
    res['fused_step_ms'] = ref_ms
    if abs(summary['mean_ms'] - ref_ms) > MESH_TIMER_TOL * ref_ms:
        raise AssertionError(f'StepTimer {summary} vs fused_step_ms '
                             f'{ref_ms}')
    del bundle, state, step
    res['profiling_s'] = time.perf_counter() - t0
    res['mesh_5k_s'] = time.perf_counter() - start
    log(f'phase 5k: {res["mesh_5k_s"]:.3f} s')
    return res


@contextlib.contextmanager
def collective_log():
    """Every collective of ``Mesh`` while inside, logged as (the calling
    stream was capturing, autograd's device thread issued it (a
    backward), the collective, its tensors' sizes)."""
    log = []
    flat = Mesh._flat
    main = threading.get_ident()

    def logged(mesh, tensors, collective):
        log.append((torch.cuda.is_current_stream_capturing(),
                    threading.get_ident() != main,
                    collective.__qualname__.split('.')[1],
                    tuple(t.numel() for t in tensors)))
        return flat(mesh, tensors, collective)
    with mock.patch.object(Mesh, '_flat', logged):
        yield log


def mesh_graph_pair(what: str, make, calls: int, expected: dict,
                    extra: int) -> dict:
    """Phase 5m: ``calls`` calls of a mesh step graphed and through
    ``.plain``, each from ``make() -> (state, step, args_of)`` (call i is
    ``step(state, *args_of(i))``), under cuDNN's deterministic
    algorithms. Raises unless the two agree at 0.0, the graphed step
    object captured once, its launches are ``expected``, and its first
    call's collectives are the eager step's (plus ``extra`` after the
    replays: the fused train step's metrics), the capture's recorded on
    the capturing stream, a backward's included."""
    recs = []
    with cudnn_deterministic():
        for graphed in (False, True):
            state, step, args_of = make()
            run = step if graphed else step.plain
            cuda.reset_launch_counts()
            with collective_log() as first:
                metrics = [run(state, *args_of(0))]
            metrics += [run(state, *args_of(i)) for i in range(1, calls)]
            torch.cuda.synchronize()
            launches = dict(cuda.LAUNCHES)
            recs.append(fused_record(state, metrics))
    r = {'gap': fused_gap(recs[0], recs[1]), 'captures': step.graphs.captures,
         'launches': launches,
         'captured_launches': [dict(g.launches)
                               for g in step.graphs.graphs.values()],
         'digest': state_digest(state.module)}
    check_launches(f'mesh graph {what}', launches, expected)
    eager = [e[1:] for e in first if not e[0]]
    captured = [e[1:] for e in first if e[0]]
    r['collectives'] = {'eager': len(eager), 'captured': len(captured),
                        'backward_captured': sum(e[1] for e in first
                                                 if e[0])}
    log(f'mesh graph {what}: graph vs plain {r["gap"]}, captures '
        f'{r["captures"]}, collectives {r["collectives"]}')
    if r['gap'][0] != 0.0 or r['captures'] != 1:
        raise AssertionError(f'mesh graph {what}: {r}')
    if (not captured or eager[:len(captured)] != captured
            or len(eager) != len(captured) + extra):
        raise AssertionError(f'mesh graph {what}: the capture recorded '
                             f'{captured}, the eager step ran {eager}')
    if state.module.training and not r['collectives']['backward_captured']:
        raise AssertionError(f'mesh graph {what}: no backward collective '
                             'was captured')
    del recs, state, step
    torch.cuda.empty_cache()
    return r


def device_kernels(fn) -> dict:
    """The device kernels of one call of ``fn`` under torch.profiler: how
    many in all, and NCCL's by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {'kernels': sum(e.count for e in device),
            'nccl': {e.key: e.count for e in device
                     if 'nccl' in e.key.lower()}}


def mesh_graph_model(cfg, banks, mesh) -> dict:
    """Phase 5m for one model on this rank (the module docstring)."""
    t0 = time.perf_counter()
    dev = mesh.device
    f32 = KERNELS[torch.float32][0]
    cfg8 = cfg.replace(bank_dtype='int8', bank_shard=True,
                       grad_accum=MESH_GRAPH_INT8[2],
                       steps_per_call=MESH_GRAPH_INT8[1])
    # the sharded steps' global batches, alike on every rank
    gen = torch.Generator(device=dev).manual_seed(31)
    batches = [shard_batch(FeatureFn(cfg, device=dev)(gen, banks['float32']),
                           mesh) for _ in range(MESH_GRAPH_CALLS)]

    def fresh(c):
        bundle = get_model(c)
        state = init_state(bundle, 0)
        replicate(state.module, mesh)
        gen = (torch.Generator(device=dev).manual_seed(41 + mesh.rank)
               if bundle.needs_dropout_gen else None)
        return bundle, state, gen

    def sharded(make_step, train: bool):
        def make():
            bundle, state, dgen = fresh(cfg)
            return state, make_step(bundle, mesh), lambda i: (
                (batches[i], dgen) if train else (batches[i],))
        return make

    def fused(make_step, c, dtype: str, train: bool):
        def make():
            bundle, state, dgen = fresh(c)
            gen = torch.Generator(device=dev).manual_seed(20 + mesh.rank)
            return (state, make_step(bundle, c, mesh=mesh,
                                     bank_sharded=c.bank_shard),
                    lambda i: (banks[dtype], gen, dgen) if train
                    else (banks[dtype], gen))
        return make
    calls8, spc8, accum8 = MESH_GRAPH_INT8
    res = {name: mesh_graph_pair(f'{cfg.model_type} {name}', make, calls,
                                 expected, extra)
           for name, make, calls, expected, extra in (
               ('sharded_train', sharded(make_sharded_train_step, True),
                MESH_GRAPH_CALLS, {}, 0),
               ('sharded_eval', sharded(make_sharded_eval_step, False),
                MESH_GRAPH_CALLS, {}, 0),
               ('fused_train_f32', fused(make_fused_train_step, cfg,
                                         'float32', True),
                MESH_GRAPH_CALLS, {f32: MESH_GRAPH_CALLS}, 1),
               ('fused_train_int8', fused(make_fused_train_step, cfg8,
                                          'int8', True),
                calls8, {'synth_mag_int8': calls8 * spc8 * accum8}, 1),
               ('fused_eval', fused(make_fused_eval_step, cfg, 'float32',
                                    False),
                MESH_GRAPH_CALLS, {f32: MESH_GRAPH_CALLS}, 0))}
    del batches
    # TrainLoop.fit on the mesh, through the graphed fused steps
    loop = TrainLoop(get_model(cfg), seed=0, banks=banks['float32'],
                     val_banks=banks['float32'], mesh=mesh)
    cuda.reset_launch_counts()
    hist = loop.fit(epochs=MESH_GRAPH_EPOCHS,
                    steps_per_epoch=MESH_GRAPH_FIT_STEPS, validation_steps=1,
                    verbose=0)
    torch.cuda.synchronize()
    fit = {'launches': dict(cuda.LAUNCHES), 'logs': hist,
           'captures': [loop.train_step.graphs.captures,
                        loop.eval_step.graphs.captures],
           'digest': state_digest(loop.state.module)}
    check_launches(f'mesh graph {cfg.model_type} fit', fit['launches'],
                   {f32: MESH_GRAPH_EPOCHS * (MESH_GRAPH_FIT_STEPS + 1)})
    if fit['captures'] != [1, 1] or not all(
            math.isfinite(v) for lg in hist for k, v in lg.items()
            if k != 'time'):
        raise AssertionError(f'mesh graph fit: {fit}')
    res['fit'] = fit
    del loop
    # the graphed mesh step, the eager mesh step and the one-process
    # graphed step, in turns, on the float32 banks
    bundle, state, dgen = fresh(cfg)
    step = make_fused_train_step(bundle, cfg, mesh=mesh)
    one = get_model(cfg)
    one_state = init_state(one, 0)
    one_step = make_fused_train_step(one, cfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    runs = {'mesh_graph_step_ms': lambda: step(state, banks['float32'], gen,
                                               dgen),
            'mesh_eager_step_ms': lambda: step.plain(state, banks['float32'],
                                                     gen, dgen),
            'fused_step_ms': lambda: one_step(one_state, banks['float32'],
                                              gen, dgen)}
    for fn in runs.values():             # captures, cuDNN's search
        wall_ms(fn, 2)
    times = {k: [] for k in runs}
    for k in ('mesh_graph_step_ms', 'mesh_eager_step_ms', 'fused_step_ms',
              'fused_step_ms', 'mesh_eager_step_ms', 'mesh_graph_step_ms'):
        times[k].append(wall_ms(runs[k], MESH_GRAPH_TIMED_STEPS))
    res.update(times)
    # a replay's kernels and the eager step's: with two or more ranks the
    # replay runs NCCL's; one rank's collectives have nothing to move
    res['replay_kernels'] = device_kernels(runs['mesh_graph_step_ms'])
    res['eager_kernels'] = device_kernels(runs['mesh_eager_step_ms'])
    log(f'mesh graph {cfg.model_type}: a replay ran '
        f'{res["replay_kernels"]}, the eager step {res["eager_kernels"]}')
    if (mesh.size > 1 and res['replay_kernels']['kernels']
            and not res['replay_kernels']['nccl']):
        raise AssertionError(f'phase 5m: no NCCL kernel in a replay on '
                             f'{mesh.size} ranks')
    del bundle, state, step, one, one_state, one_step, runs
    torch.cuda.empty_cache()
    res['seconds'] = time.perf_counter() - t0
    return res


def mesh_graph_rank(args: dict) -> dict:
    """What each rank of phase 5m runs, on a card of its own over NCCL;
    rank 0 is this script's process, any other rank a child that imports
    this module."""
    mesh = current()
    if not mesh.capturable:
        raise AssertionError(f'phase 5m: a {mesh.backend} mesh over '
                             f'{mesh.devices} cannot be captured')
    banks = {dtype: mesh_banks(dtype, shard, mesh)
             for dtype, shard in (('float32', False), ('int8', True))}
    out = {'rank': mesh.rank, 'backend': mesh.backend}
    for name, cfg in (('vad_v8', Config(model_type='vad', v=8)),
                      ('eff_b0_v1', Config(model_type='eff', model=0, v=1))):
        out[name] = mesh_graph_model(cfg, banks, mesh)
    # no graph that holds NCCL's work outlives the communicator, which
    # the rank destroys when it leaves the mesh
    gc.collect()
    torch.cuda.synchronize()
    return out


def mesh_graph_run(devices, d: str) -> dict:
    """Phase 5m over ``devices``, a rank each; the ranks' states equal
    bit for bit after each run. Returns rank 0's results."""
    ranks = launch.run('chip_smoke:mesh_graph_rank', ({},), devices,
                       workdir=d)
    if {r['backend'] for r in ranks} != {'nccl'}:
        raise AssertionError(f'phase 5m: backends {ranks}')
    for model in ('vad_v8', 'eff_b0_v1'):
        for run, r in ranks[0][model].items():
            if isinstance(r, dict) and 'digest' in r and len({
                    rk[model][run]['digest'] for rk in ranks}) != 1:
                raise AssertionError(f'phase 5m {model} {run}: the ranks\' '
                                     'state_dicts differ')
        if len({json.dumps([{k: v for k, v in lg.items() if k != 'time'}
                            for lg in rk[model]['fit']['logs']])
                for rk in ranks}) != 1:
            raise AssertionError(f'phase 5m {model}: the ranks log '
                                 'different metrics')
    return ranks[0]


def mesh_graph_checks(d: str) -> dict:
    """Phase 5m: the mesh steps as CUDA graphs over NCCL, a one-rank mesh
    on this card, and a two-rank one where two cards are visible."""
    start = time.perf_counter()
    res = {'torch': torch.__version__,
           'nccl': '.'.join(map(str, torch.cuda.nccl.version())),
           'one_rank': mesh_graph_run([torch.device('cuda', 0)], d)}
    if torch.cuda.device_count() >= 2:
        res['two_ranks'] = mesh_graph_run(
            [torch.device('cuda', i) for i in range(2)], d)
    else:
        res['two_ranks'] = None
        log('phase 5m: the two-rank NCCL run needs two cards; this host '
            'has one')
    res['launches'] = {
        k: sum(r[run]['launches'].get(k, 0) for r in (
            res['one_rank']['vad_v8'], res['one_rank']['eff_b0_v1'])
            for run in r
            if isinstance(r[run], dict) and 'launches' in r[run])
        for k in (KERNELS[torch.float32][0], 'synth_mag_int8')}
    res['mesh_5m_s'] = time.perf_counter() - start
    log(f'phase 5m: {res["mesh_5m_s"]:.3f} s')
    return res


@contextlib.contextmanager
def plain_synthesis():
    """``ops.synth``'s magnitude, flat-complex and se-triple wrappers, which
    ``data.mixture`` calls, swapped for their plain versions: a route's
    plain output on the card."""
    plain = {'synthesize_magnitude': synthesize_magnitude_plain,
             'synthesize_flat': synthesize_flat_plain,
             'synthesize_se': synthesize_se_plain}
    saved = {k: getattr(synth_lib, k) for k in plain}
    for k, fn in plain.items():
        setattr(synth_lib, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(synth_lib, k, fn)


def tensors_of(tree) -> list:
    """The tensors of a (nested) tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in tensors_of(item)]


def sample_batch_checks(banks) -> dict:
    """Phase 5l's ``sample_batch``: the main path's batch (12 x 512
    frames, 7 voice and 2 noise slots) on each bank dtype, through each
    route; returns each route's largest difference from its plain
    version (0.0 required)."""
    cfg = Config(model_type='vad', v=8)
    res, launches = {}, {}
    for name, dt in FLAT_DTYPES.items():
        gen = torch.Generator(device=banks[name].backgrounds.flat.device)
        for route, kw, kernel in (
                ('ftc', dict(layout='ftc'), FLAT_KERNELS[dt]),
                ('tfc', dict(layout='tfc'), FLAT_KERNELS[dt]),
                ('magnitude', dict(layout='tfc', magnitude=True),
                 KERNELS[dt][0]),
                ('se', dict(seperate_noise_voice=True), SE_KERNELS[dt])):
            def run():
                return mixture.sample_batch(
                    gen.manual_seed(21), banks[name], cfg.batch_size,
                    cfg.n_frame, max_voices=cfg.max_voices,
                    max_noises=cfg.max_noises, snr=cfg.snr, **kw)
            cuda.reset_launch_counts()
            out = run()
            torch.cuda.synchronize()
            check_launches(f'sample_batch {name} {route}',
                           dict(cuda.LAUNCHES), {kernel: 1})
            launches[kernel] = launches.get(kernel, 0) + 1
            with plain_synthesis():
                ref = run()
            a, b = tensors_of(out), tensors_of(ref)
            if [(t.shape, t.dtype) for t in a] != [(t.shape, t.dtype)
                                                   for t in b]:
                raise AssertionError(f'sample_batch {name} {route}: shapes')
            res[f'{name}_{route}'] = max(
                float((x.float() - y.float()).abs().max()) for x, y in
                zip(a, b))
    log('sample_batch vs plain, max abs diff: ' + json.dumps(res))
    if any(v != 0.0 for v in res.values()):
        raise AssertionError('sample_batch disagrees with its plain version')
    return {'max_abs_diff': res, 'launches': launches}


def iter_run(make, banks, graphed: bool, d: str):
    """One phase 5l run of ``make() -> (loop, cfg, variant, n_classes)``:
    a fit of 1 + ITER_STEPS steps and 1 + ITER_VAL_STEPS validation
    steps, ``set_weights`` (halved), a step, ``save_train_state``, a
    step, ``restore_train_state``, a step and a validation step; graphed
    or through the steps' ``.plain``. Returns (record, launches, the
    loop's train and eval steps)."""
    loop, cfg, variant, n_classes = make()
    steps = loop.train_step, loop.eval_step
    if not graphed:
        loop.train_step, loop.eval_step = steps[0].plain, steps[1].plain
    train, val = (iter(DevicePipeline(banks, cfg, training, variant=variant,
                                      n_classes=n_classes))
                  for training in (True, False))
    cuda.reset_launch_counts()
    logs = loop.fit(train, epochs=1, steps_per_epoch=1 + ITER_STEPS,
                    validation_iter=val,
                    validation_steps=1 + ITER_VAL_STEPS, verbose=0)
    loop.set_weights({k: v * 0.5 if v.is_floating_point() else v
                      for k, v in loop.get_weights().items()})
    logs.append(loop.run_epoch(train, 1, True, epoch=1))
    save_train_state(d, loop.state)
    logs.append(loop.run_epoch(train, 1, True, epoch=2))
    restore_train_state(d, loop.state)
    logs.append(loop.run_epoch(train, 1, True, epoch=2))
    logs.append(loop.run_epoch(val, 1, False, epoch=2))
    torch.cuda.synchronize()
    metrics = [{k: torch.tensor(v) for k, v in lg.items() if k != 'time'}
               for lg in logs]
    return fused_record(loop.state, metrics), dict(cuda.LAUNCHES), steps


def iter_configs(banks, banks2048):
    """Phase 5l's configurations: (name, banks, make) with ``make() ->
    (TrainLoop from seed 0, config, variant, n_classes)``."""
    ns = density_args()
    dcfg = trainer.to_config(ns)

    def density():
        return (TrainLoop(get_density_model(dcfg, seed=dcfg.seed), seed=0,
                          loss_fn=trainer.make_loss_fn(ns)),
                dcfg, 'density', ns.n_classes)

    def sj(cfg):
        return lambda: (TrainLoop(get_model(cfg), seed=0), cfg, 'sj', None)
    return (('density', banks2048, density),
            ('vad_v8', banks, sj(Config(model_type='vad', v=8))),
            ('eff_b0_v1', banks, sj(Config(model_type='eff', model=0,
                                           v=1))))


def iter_graph_checks(banks, banks2048) -> dict:
    """Phase 5l (the module docstring)."""
    start = time.perf_counter()
    kernel = KERNELS[torch.float32][0]
    res = {'launches': 0}          # the float32 magnitude kernel's, in 5l
    d = tempfile.mkdtemp(prefix='chip_smoke_5l_')
    try:
        for name, bk, make in iter_configs(banks['float32'],
                                           banks2048['float32']):
            t0 = time.perf_counter()
            r = res[name] = {}
            recs = []
            with cudnn_deterministic():
                for graphed in (True, False):
                    rec, launches, steps = iter_run(
                        make, bk, graphed, os.path.join(d, f'{name}{graphed}'))
                    # the pipeline's batches: the fit's, 3 training and 1
                    # validation batch after it
                    check_launches(f'iter {name} graphed {graphed}',
                                   launches, {kernel: 1 + ITER_STEPS + 3
                                              + 1 + ITER_VAL_STEPS + 1})
                    res['launches'] += launches[kernel]
                    if graphed:
                        r['captures'] = [s.graphs.captures for s in steps]
                        r['captured_launches'] = [
                            dict(g.launches) for s in steps
                            for g in s.graphs.graphs.values()]
                    recs.append(rec)
                    del rec, steps
                    torch.cuda.empty_cache()
            r['graph_gap'] = fused_gap(recs[1], recs[0])
            log(f'iter {name}: graph vs plain {r["graph_gap"]}, captures '
                f'{r["captures"]}')
            if r['graph_gap'][0] != 0.0 or r['captures'] != [1, 1]:
                raise AssertionError(f'iter {name}: graph vs plain '
                                     f'{r["graph_gap"]}, captures '
                                     f'{r["captures"]}')
            del recs
            # graphed against eager, in turns, with the default algorithms
            loop, cfg, variant, n_classes = make()
            it = iter(DevicePipeline(bk, cfg, variant=variant,
                                     n_classes=n_classes))
            loop.fit(it, epochs=1, steps_per_epoch=3, verbose=0)
            graphed = loop.train_step
            r['iter_step_ms'], r['eager_iter_step_ms'] = [], []
            for g in (True, False, False, True):
                loop.train_step = graphed if g else graphed.plain
                r['iter_step_ms' if g else 'eager_iter_step_ms'].append(
                    wall_ms(lambda: loop.run_epoch(it, ITER_TIMED_STEPS,
                                                   True), 1)
                    / ITER_TIMED_STEPS)
            del loop, it, graphed
            torch.cuda.empty_cache()
            r['seconds'] = time.perf_counter() - t0
            log(f'iter {name}: {json.dumps(r)}')
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # the graphed fused eval step of vad v8 against its plain version
    cfg = Config(model_type='vad', v=8)
    recs = []
    with cudnn_deterministic():
        for graphed in (False, True):
            bundle = get_model(cfg)
            state = init_state(bundle, 0)
            step = make_fused_eval_step(bundle, cfg)
            gen = torch.Generator(device=bundle.device).manual_seed(13)
            run = step if graphed else step.plain
            cuda.reset_launch_counts()
            metrics = [run(state, banks['float32'], gen) for _ in range(3)]
            torch.cuda.synchronize()
            check_launches(f'fused eval graphed {graphed}',
                           dict(cuda.LAUNCHES), {kernel: 3})
            res['launches'] += 3
            if graphed:
                res['fused_eval_captured'] = [
                    dict(g.launches) for g in step.graphs.graphs.values()]
                if res['fused_eval_captured'] != [{kernel: 1}]:
                    raise AssertionError(f'fused eval captured '
                                         f'{res["fused_eval_captured"]}')
            recs.append(fused_record(state, metrics))
    res['fused_eval_gap'] = fused_gap(recs[0], recs[1])
    if res['fused_eval_gap'][0] != 0.0:
        raise AssertionError(f'fused eval graph vs plain '
                             f'{res["fused_eval_gap"]}')
    res['fused_eval_ms'], res['eager_fused_eval_ms'] = [], []
    for g in (True, False, False, True):
        run = step if g else step.plain
        res['fused_eval_ms' if g else 'eager_fused_eval_ms'].append(
            wall_ms(lambda: run(state, banks['float32'], gen), 20))
    del bundle, state, step, recs
    res['sample_batch'] = sample_batch_checks(banks)
    res['iter_5l_s'] = time.perf_counter() - start
    log(f'phase 5l: {res["iter_5l_s"]:.3f} s')
    return res


def stream_resume_cli_chain(d: str) -> dict:
    """Phase 7g, in the CLI chain's directory ``d``: ``cli.sj_train`` vad v8
    on an int8 rotation of 2 chunks with full-state checkpoints, 2 epochs
    then resumed to 3; ``cli.trainer`` at its defaults with ``--grad_accum
    2`` and ``--ckpt_dir``, 2 epochs of 1 step then resumed to 3."""
    start = time.perf_counter()
    res = {'stream_cli_launches': [], 'stream_cli_s': []}
    ck = os.path.join(d, 'ck7g')
    base = ['--model_type', 'vad', '--v', '8', '--n_chan', '2',
            '--datapath', d, '--name', 'stream7g', '--bank_dtype', 'int8',
            '--stream_chunks', '2', '--chunk_steps', '2', '--ckpt_dir', ck,
            '--ckpt_every_epochs', '1', '--steps_per_epoch', str(CLI_STEPS)]
    files = Config()
    dens = ['--name', 'dens7g', '--n_chan', '2', '--grad_accum', '2',
            '--ckpt_dir', os.path.join(d, 'ck7g_density'),
            '--steps_per_epoch', '1', '--datapath', d]
    for flag in ('background_sounds', 'voices', 'labels', 'noises',
                 'test_background_sounds', 'test_voices', 'test_labels'):
        dens += [f'--{flag}', getattr(files, flag)]
    # (which, argv, its kernel, training batches an epoch, the step saved
    # after 2 epochs, main): the trainer's step is 2 microbatches
    for which, argv, kernel, steps, saved, main in (
            ('sj_train', base, 'synth_mag_int8', CLI_STEPS, 2 * CLI_STEPS,
             sj_train.main),
            ('trainer', dens, 'synth_mag_f32', 2, 2, trainer.main)):
        for epochs, extra in ((2, []), (3, ['--resume', 'True'])):
            trained = 1 if extra else epochs
            batches = trained * (steps + CLI_VAL_STEPS)
            with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
                run, counts, secs = run_cli(argv + ['--epochs', str(epochs)]
                                            + extra, kernel, batches,
                                            main=main)
            res['stream_cli_launches'].append(counts)
            res['stream_cli_s'].append(secs)
            text = out.getvalue()
            if extra:
                line = f'resumed from step {saved} (epoch 2)'
                if line not in text or 'Epoch 3/3' not in text or \
                        'Epoch 2/3' in text:
                    raise AssertionError(f'{which} did not resume: {line!r}')
        ckpt_dir = argv[argv.index('--ckpt_dir') + 1]
        res[f'{which}_ckpt_steps'] = checkpoint_steps(ckpt_dir)
        log_file = run + ('.csv' if which == 'sj_train' else '.log')
        with open(log_file) as f:
            rows = f.read().strip().splitlines()
        if len(rows) != 4 or not rows[0].startswith('epoch'):
            raise AssertionError(f'{log_file}: {rows}')
        if which == 'sj_train':
            check_trio(run)
    if res['sj_train_ckpt_steps'] != [5, 10, 15] or \
            res['trainer_ckpt_steps'] != [2, 3]:
        raise AssertionError(f'checkpoint steps: {res}')
    res['stream_7g_s'] = time.perf_counter() - start
    log(f'phase 7g: {res["stream_7g_s"]:.3f} s')
    return res


KERAS_EPOCHS = 8          # phase 7h: get_csv_data evaluates a log of > 5
                          # lines past --patience 1 (its reference's rule)
EXPORT_REPS = 20          # phase 7h: forwards timed a turn


def record_grids(fn):
    """``fn()`` with the 0/1 grids that ``evaluate`` scores recorded:
    (its result, [grid, ...])."""
    grids, orig = [], infer.get_start_end_frame

    def rec(grid):
        grids.append(np.asarray(grid))
        return orig(grid)
    infer.get_start_end_frame = rec
    try:
        return fn(), grids
    finally:
        infer.get_start_end_frame = orig


def artifact_ers(fn, paths, answers):
    """The per-clip ERs and grids of an ``export_eval`` artifact ``fn``
    over ``paths``: PCM read on the host, one call on the card, each grid
    cut to its clip's valid rows and scored."""
    pcm, lens = infer._prepare_batched_pcm(paths)
    grids = fn(torch.from_numpy(pcm).cuda(),
               torch.from_numpy(lens).cuda()).cpu().numpy()
    to_metric = events.output_to_metric(256, SR)
    grids = [g[:int(n) // 256 + 1] for g, n in zip(grids, lens)]
    ers = [events.get_er(np.asarray(answers[os.path.basename(p)[:-4]]),
                         to_metric(*events.get_start_end_frame(g)))
           for p, g in zip(paths, grids)]
    return ers, grids


def same_grids(what: str, a, b) -> None:
    if len(a) != len(b) or any(x.shape != y.shape or not np.array_equal(x, y)
                               for x, y in zip(a, b)):
        raise AssertionError(f'{what}: grids differ')


def export_infer_check(name: str, cfg) -> dict:
    """Phase 7h(d) for one model: ``export_infer`` of ``cfg`` at full width
    (weights from seed 7), reloaded from its bytes with the module deleted,
    at batch 2 and at the window count of a 60 s clip, under cuDNN's
    deterministic algorithms; then the forward of the artifact against the
    module's, in turns."""
    from challenge_tpu_torch.interop.aot import export_infer, load_infer
    res = {}
    bundle = get_model(cfg, seed=7)
    module = bundle.module.eval()
    n_win = -(-(60 * SR // 256 + 1) // 512)
    gen = torch.Generator(device='cuda').manual_seed(3)
    xs = [torch.randn((b,) + bundle.input_shape, generator=gen,
                      device='cuda') for b in (2, n_win)]
    with cudnn_deterministic(), torch.no_grad():
        want = [module(x) for x in xs]
        t0 = time.perf_counter()
        data = export_infer(bundle, cfg)
        res['export_s'] = time.perf_counter() - t0
        res['artifact_mb'] = len(data) / 1e6
        del bundle, module
        t0 = time.perf_counter()
        fn = load_infer(data)
        res['load_s'] = time.perf_counter() - t0
        got = [fn(x) for x in xs]
    res['batches'] = [int(x.shape[0]) for x in xs]
    res['max_abs_gap'] = [float((g - w).abs().max()) for g, w in
                          zip(got, want)]
    peak = max(float(w.abs().max()) for w in want)
    if max(res['max_abs_gap']) > 1e-5 * peak:
        raise AssertionError(f'export_infer {name}: {res["max_abs_gap"]} '
                             f'beyond 1e-5 of the peak {peak}')
    res['forward_ms'], res['module_forward_ms'] = [], []
    module = get_model(cfg, seed=7).module.eval()    # the same weights
    with torch.no_grad():
        for which in ('artifact', 'module', 'module', 'artifact'):
            f = fn if which == 'artifact' else module
            res['forward_ms' if which == 'artifact' else
                'module_forward_ms'].append(gpu_ms(f, [(xs[1],)],
                                                   EXPORT_REPS))
    log(f'export_infer {name}: {json.dumps(res)}')
    return res


def make_it_fire(cfg, module, paths) -> None:
    """Make ``module`` predict events on the windows of ``paths``: its BN
    statistics set to theirs, as phase 8 does, then per class its output
    layer shifted and scaled so that the threshold lies in the middle of
    the widest gap between the upper half of the sorted logits and the
    logits next to it lie ``SHARP`` from it. Phase 8 keeps a class whose
    gap is under ``MIN_GAP`` silent; here every class fires, however
    narrow its gap (the 768 logits of 48 windows lie close together)."""
    x = clip_windows(cfg, module, paths)
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    momenta = [m.momentum for m in bns]
    logits = []
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.0
        module.train()(x)
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
        last = module.fcs[-1].dense
        hook = last.register_forward_hook(
            lambda mod, args, out: logits.append(out))
        module.eval()(x)
        hook.remove()
        zs = torch.sort(logits[-1].reshape(-1, last.out_features),
                        dim=0).values
        n = zs.shape[0]
        gaps = zs[n // 2 + 1:] - zs[n // 2:-1]
        k = gaps.argmax(dim=0) + n // 2
        cols = torch.arange(zs.shape[1], device=zs.device)
        mid = (zs[k, cols] + zs[k + 1, cols]) / 2
        scale = 2 * SHARP / gaps.amax(dim=0).clamp(min=1e-30)
        last.bias.copy_((last.bias - mid) * scale)
        last.weight.mul_(scale[:, None])


def keras_export_chain(d: str) -> dict:
    """Phase 7h, in ``d/keras7h`` (the dev set linked in from ``d``, the
    spec sets read from ``d``): h5py's status; ``cli.sj_train`` vad v8 on
    int8 banks through the graphed step, with ``--keras_ckpt True`` where
    h5py imports (its Keras trio then read back by ``cli.eval`` against
    ``torch.save`` copies, one Keras save and load timed); ``export_infer``
    of vad v8 and v9; ``export_eval`` of the run's best weights, made to
    fire, against ``evaluate(batched=True)`` and the per-clip path, each
    timed; the batched eval's peak memory per family; then
    ``cli.get_csv_data`` on the run."""
    from challenge_tpu_torch.cli import get_csv_data
    from challenge_tpu_torch.interop.aot import export_eval, load_infer
    start = time.perf_counter()
    res = {}
    try:
        import h5py
        res['h5py'] = h5py.__version__
    except ImportError:
        res['h5py'] = None
    log('H5PY ' + json.dumps({'h5py': res['h5py']}))
    if res['h5py'] is None:
        log('KERAS ' + json.dumps({'h5py': None}))
    sub = os.path.join(d, 'keras7h')
    os.makedirs(sub)
    with open(os.path.join(d, 'sample_answer.json')) as f:
        answers = json.load(f)['task2_answer']
    for name in os.listdir(d):
        if name.endswith('.wav') or name == 'sample_answer.json':
            os.symlink(os.path.join(d, name), os.path.join(sub, name))
    paths = sorted(p for p in os.listdir(sub) if p.endswith('.wav'))
    cwd = os.getcwd()
    os.chdir(sub)
    try:
        cfg = Config(model_type='vad', v=8)
        batches = KERAS_EPOCHS * (CLI_STEPS + CLI_VAL_STEPS)
        keras = ['--keras_ckpt', 'True'] if res['h5py'] else []
        run, counts, res['keras_cli_s'] = run_cli(
            ['--model_type', 'vad', '--v', '8', '--n_chan', '2',
             '--datapath', d, '--name', 'keras7h', '--bank_dtype', 'int8',
             '--epochs', str(KERAS_EPOCHS), '--steps_per_epoch',
             str(CLI_STEPS)] + keras, 'synth_mag_int8', batches)
        if {k for k, v in counts.items() if v} != {'synth_mag_int8'}:
            raise AssertionError(f'7h launches: {counts}')
        res['keras_launches'], res['keras_batches'] = counts, batches
        res.update(trio_check(run, paths, bool(keras)))
        for name, c in (('vad_v8', cfg), ('vad_v9', Config(model_type='vad',
                                                            v=9))):
            res[f'export_{name}'] = export_infer_check(name, c)
        # (e) the eval chain over the 6 x 60 s dev set
        bundle = get_model(cfg)
        module = bundle.module
        module.load_state_dict(load_weights(run + '.h5', 'cuda', bundle))
        make_it_fire(cfg, module, paths)
        lens, chan = infer._wav_headers(paths)
        t0 = time.perf_counter()
        data = export_eval(bundle, cfg, s_max=int(lens.max()),
                           wav_channels=chan)
        res['export_eval_s'] = time.perf_counter() - t0
        res['export_eval_mb'] = len(data) / 1e6
        fn = load_infer(data)
        runs = {
            'per_clip': lambda: record_grids(lambda: infer.evaluate(
                cfg, module, batched=False)),
            'batched': lambda: record_grids(lambda: infer.evaluate(
                cfg, module)),
            'artifact': lambda: artifact_ers(fn, paths, answers)}
        out, res['eval_s'] = {}, {k: [] for k in runs}
        for which in ('per_clip', 'batched', 'artifact', 'per_clip',
                      'batched', 'artifact', 'artifact', 'batched',
                      'per_clip'):            # a warm-up turn, then timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[which] = runs[which]()
            torch.cuda.synchronize()
            res['eval_s'][which].append(time.perf_counter() - t0)
        res['eval_warmup_s'] = {k: v.pop(0) for k, v in res['eval_s'].items()}
        for which in ('batched', 'artifact'):
            same_grids(f'{which} vs per-clip', out[which][1],
                       out['per_clip'][1])
            if out[which][0] != out['per_clip'][0]:
                raise AssertionError(f'{which} ERs {out[which][0]}')
        grids = out['per_clip'][1]
        res['eval_frames_on'] = sum(int(g.sum()) for g in grids) / sum(
            g.size for g in grids)
        if not 0 < res['eval_frames_on'] < 1:
            raise AssertionError('7h(e): degenerate grids')
        res['eval_ers'] = out['per_clip'][0]
        log('7h eval: ' + json.dumps({k: res[k] for k in (
            'eval_s', 'eval_warmup_s', 'eval_ers', 'eval_frames_on',
            'export_eval_s', 'export_eval_mb')}))
        del fn, bundle, module
        res.update(batched_peaks(paths))
        # (f) get_csv_data over the run's directory: one row, the trio's
        # ERs at its overlap_hop of framelen // 2
        rows = get_csv_data.main(argv=['--path', sub, '--patience', '1'])
        want = [float(np.mean(res['ers_hop256'][s]))
                for s in ('', '_SWA', '_sample')]
        got = [float(x) for x in rows[1][-3:]] if len(rows) == 2 else []
        if len(rows) != 2 or rows[1][0] != run or got != want or \
                not all(map(math.isfinite, got)):
            raise AssertionError(f'get_csv_data rows {rows}, want {want}')
        res['csv_ers'] = got
    finally:
        os.chdir(cwd)
    res['keras_7h_s'] = time.perf_counter() - start
    log(f'phase 7h: {res["keras_7h_s"]:.3f} s')
    return res


def trio_check(run: str, paths, keras: bool) -> dict:
    """Phase 7h(c): each file of the trio is first made to predict events
    (:func:`make_it_fire`; a few steps leave the model silent) and written
    back in its format; then ``cli.eval --p`` on it. Keras files
    (``keras``) must be HDF5 and give the ERs and grids of a
    ``torch.save`` copy of the same weights, and one Keras save and one
    load of the best weights are timed. The ERs at overlap_hop 256
    (``get_csv_data``'s) are kept."""
    res = {'ers': {}, 'ers_hop256': {}, 'frames_on': {}}
    os.makedirs('tsave')
    cfg = Config(model_type='vad', v=8)
    bundle = get_model(cfg)
    for suffix in ('', '_SWA', '_sample'):
        path = f'{run}{suffix}.h5'
        with open(path, 'rb') as f:
            if (f.read(8) == b'\x89HDF\r\n\x1a\n') != keras:
                raise AssertionError(f'{path}: HDF5 is {not keras}')
        bundle.module.load_state_dict(load_weights(path, 'cuda', bundle))
        make_it_fire(cfg, bundle.module, paths)
        save_weights(path, bundle.module.state_dict(), keras=keras,
                     bundle=bundle)
        ers, grids = record_grids(lambda: eval_cli.main(
            ['--name', run + suffix, '--p']))
        res['frames_on'][suffix] = sum(int(g.sum()) for g in grids) / sum(
            g.size for g in grids)
        if len(ers) != len(paths) or not all(map(math.isfinite, ers)) or \
                not 0 < res['frames_on'][suffix] < 1:
            raise AssertionError(f'{path}: ERs {ers}, {res["frames_on"]}')
        weights = load_weights(path, 'cuda', bundle)
        if keras:
            save_weights(os.path.join('tsave', path), weights)
            plain, pg = record_grids(lambda: eval_cli.main(
                ['--name', run + suffix, '--p', '--path', 'tsave']))
            same_grids(f'Keras {path} vs torch.save', grids, pg)
            if ers != plain:
                raise AssertionError(f'{path}: ERs {ers} vs {plain}')
        res['ers'][suffix] = ers
        bundle.module.load_state_dict(weights)
        res['ers_hop256'][suffix] = infer.evaluate(cfg, bundle.module,
                                                   overlap_hop=256)
    if keras:
        res['keras_save_ms'], res['keras_load_ms'] = [], []
        sd = bundle.module.state_dict()
        for _ in range(3):
            res['keras_save_ms'].append(wall_ms(lambda: save_weights(
                'timed.h5', sd, keras=True, bundle=bundle), 1))
            res['keras_load_ms'].append(wall_ms(lambda: load_weights(
                'timed.h5', 'cuda', bundle), 1))
        res['keras_file_mb'] = os.path.getsize('timed.h5') / 1e6
    log(f'trio {run}: {json.dumps(res)}')
    return res


def batched_peaks(paths) -> dict:
    """The batched eval's peak device memory over the corpus' PCM bytes,
    for vad v8 and v9, se v9, eff B0 v1 and B7 v6 (random weights): what
    ``infer.PEAK_PER_PCM_BYTE`` bounds."""
    res = {}
    lens, chan = infer._wav_headers(paths)
    pcm_bytes = 2 * chan * int(lens.sum())
    for name, cfg in (('vad_v8', Config(model_type='vad', v=8)),
                      ('vad_v9', Config(model_type='vad', v=9)),
                      ('se_v9', Config(model_type='se', v=9)),
                      ('eff_b0_v1', Config(model_type='eff', v=1)),
                      ('eff_b7_v6', Config(model_type='eff', model=7, v=6))):
        module = get_model(cfg, seed=1).module.eval()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grids = infer.batched_grids(cfg, module, paths,
                                    cap=pcm_bytes)     # one chunk
        torch.cuda.synchronize()
        if grids is None or len(grids) != len(paths):
            raise AssertionError(f'{name}: no batched grids')
        res[f'peak_per_pcm_byte_{name}'] = (
            torch.cuda.max_memory_allocated() - base) / pcm_bytes
        del module
    res['pcm_bytes'] = pcm_bytes
    log(f'batched eval peaks: {json.dumps(res)}')
    return res


def density_args(extra=()):
    """The density trainer's flags at their defaults, with ``--n_chan 2``
    (at its default 1 it refuses to train, ROADMAP C9)."""
    return trainer.build_args().parse_args(['--name', 'dens', '--n_chan',
                                            '2', *extra])


def density_config() -> Config:
    return trainer.to_config(density_args())


def bf16_reference_check(dev) -> dict:
    """Phase 4g: ``compute_dtype='bfloat16'`` on the card against the CPU
    on the small inputs of phases 4-4f: vad v8 and v9 (80 mels, 64
    frames, batch 4), eff B0 v5 and v7 (40 mels, 256 frames, batch 2,
    fixed keep masks), se v9 pretrain (batch 2, 32 frames) and the density
    head (B0, 2 gated layers, 40 x 256, batch 2, its loss with the kernel
    penalty). One set of weights, input and labels goes to the card's
    bfloat16 model, the CPU's and a float64 copy computing in float64:
    one training-mode forward, the loss and the gradients of every
    parameter. The card's distance from the float64 copy, the largest
    over the peak, must be at most twice the CPU's, for the outputs with
    the loss and for the gradients. The card takes cuDNN's heuristic
    choice of algorithm here (``cudnn.benchmark`` off): with the timed
    search, the card's first bfloat16 calls at these small shapes, which
    no other phase runs, took 60 of the phase's 72 s on an NVIDIA H100
    80GB HBM3 at 700.00 W."""
    cpu = torch.device('cpu')
    rng = np.random.default_rng(13)
    ns = density_args()
    cases = {
        'vad_v8': (Config(model_type='vad', v=8, n_frame=64), 4),
        'vad_v9': (Config(model_type='vad', v=9, n_frame=64), 4),
        'eff_b0_v5': (Config(model_type='eff', v=5, n_mels=40,
                             n_frame=256), 2),
        'eff_b0_v7': (Config(model_type='eff', v=7, n_mels=40,
                             n_frame=256), 2),
        'se_v9': (Config(model_type='se', v=9, n_frame=32, pretrain=True),
                  2),
        'density': (trainer.to_config(ns).replace(
            model='EfficientNetB0', n_layers=2, n_mels=40, n_frame=256),
            2)}
    density_loss_fn = trainer.make_loss_fn(ns)

    def loss_of(name, y, o, m):
        if name == 'se_v9':
            return se_loss(y, o)[0]
        if name != 'density':
            return binary_crossentropy(y[0], o[0])
        if getattr(density_loss_fn, 'needs_params', False):
            return density_loss_fn(y[0], o[0], m)[0]
        return density_loss_fn(y[0], o[0])[0]
    gaps = {}
    for seed, (name, (cfg, batch)) in enumerate(cases.items()):
        t0 = time.perf_counter()
        cfg = cfg.replace(compute_dtype='bfloat16')
        bundle = (get_density_model if name == 'density' else get_model)(
            cfg, device=cpu, seed=seed)
        m_c = bundle.module
        x = torch.from_numpy(rng.standard_normal(
            (batch,) + bundle.input_shape, dtype=np.float32))
        if bundle.needs_dropout_gen:
            fix_keep_masks(m_c, x, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs = m_c.train()(x, torch.Generator()) \
                if bundle.needs_dropout_gen else m_c.train()(x)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if name == 'density':
            y = (torch.from_numpy(rng.random(outs[0].shape, np.float32) * 4),)
        else:
            y = (torch.from_numpy((rng.random(outs[0].shape) < 0.5)
                                  .astype(np.float32)),)
            y += tuple(torch.from_numpy(rng.standard_normal(
                o.shape[:-1] + (1,), dtype=np.float32)) for o in outs[1:])
        f64 = copy.deepcopy(m_c).double()
        set_compute_dtype(f64, None)
        models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev), 'f64': f64}
        res, secs = {}, {}
        torch.backends.cudnn.benchmark = False
        for key, m in models.items():
            t1 = time.perf_counter()
            where = dev if key == 'card' else cpu
            dt = torch.float64 if key == 'f64' else torch.float32
            xb = x.to(where, dt)
            yb = tuple(t.to(where, dt) for t in y)
            o = (m.train()(xb, torch.Generator(device=where))
                 if bundle.needs_dropout_gen else m.train()(xb))
            o = o if isinstance(o, tuple) else (o,)
            loss = loss_of(name, yb, o, m)
            grads = torch.autograd.grad(loss, list(m.parameters()),
                                        allow_unused=True)
            res[key] = (
                torch.cat([t.detach().double().cpu().flatten()
                           for t in (*o, loss)]),
                torch.cat([(torch.zeros_like(p) if g is None else g)
                           .double().cpu().flatten()
                           for p, g in zip(m.parameters(), grads)]))
            secs[key] = time.perf_counter() - t1
        torch.backends.cudnn.benchmark = True        # as the entry points
        g = gaps[name] = {'seconds': secs,
                          'total_s': time.perf_counter() - t0}
        for i, what in enumerate(('forward', 'gradients')):
            ref = res['f64'][i]
            for key in ('cpu', 'card'):
                g[f'{what}_{key}'] = float((res[key][i] - ref).abs().max()
                                           / ref.abs().max())
            if g[f'{what}_card'] > 2 * g[f'{what}_cpu']:
                raise AssertionError(f'bf16 {name} {what} on the card '
                                     f'beyond twice the CPU\'s: {g}')
    log('card vs CPU in bfloat16, small input: gaps to float64 over the '
        f'peak {json.dumps(gaps)}')
    return {'bf16_gaps': gaps}


def density_reference_check(dev) -> dict:
    """Phase 4f: the density model on the card against the CPU on a small
    input (batch 2, B0 with the density head and 2 gated layers, 40 mels,
    256 frames), every copy with the same keep masks: one training-mode
    forward and its loss (the count + TV loss with the kernel penalty),
    then one training step with AdaBelief and clipvalue.

    * The forward and loss on the card's float32 against a float64 CPU
      copy: within ``SCORE_TOL`` of their peak.
    * The step's gradients against the float64 copy's: within
      ``DENSITY_GRAD_TOL`` of the peak over all tensors, and within
      ``DENSITY_LEAF_TOL`` of each tensor's own peak. A tensor whose
      float64 peak is below ``DENSITY_LEAF_FLOOR`` of the peak over all
      is held to the first bound only: the biases of the BNs that feed a
      1x1 conv and another BN, whose shift that BN's batch mean takes
      away, have gradients of about 1e-14 in float64 and of float32
      rounding noise on the card.
    * The update: every tensor with a gradient moves and no other, and
      the card's new weights equal AdaBelief's in float64 from the card's
      own weights and gradients within ``DENSITY_STEP_ULPS`` float32
      epsilons of (|weight| + lr). The update is not held to the float64
      copy's: AdaBelief moves every element whose gradient is above about
      3e-6 by about the learning rate, whatever its size, so float32
      rounding noise on a gradient that is 0 in float64 moves a weight by
      a good part of it (ROADMAP C2)."""
    cpu = torch.device('cpu')
    ns = density_args()
    cfg = trainer.to_config(ns).replace(model='EfficientNetB0', n_layers=2,
                                        n_mels=40, n_frame=256, batch_size=2)
    loss_fn = trainer.make_loss_fn(ns)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 40, 256, 2),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.random((2, 8, 3), dtype=np.float32) * 4)
    m_c = get_density_model(cfg, device=cpu, seed=4).module
    fix_keep_masks(m_c, x, torch.Generator().manual_seed(4))
    models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
              'f64': copy.deepcopy(m_c).double()}
    names = [n for n, _ in m_c.named_parameters()]
    fwd, grad, step_gap = {}, {}, {}
    for key, m in models.items():
        where = dev if key == 'card' else cpu
        dt = torch.float64 if key == 'f64' else torch.float32
        xb, yb = x.to(where, dt), y.to(where, dt)
        with torch.no_grad():
            o = m.train()(xb, torch.Generator(device=where))
            loss, _ = loss_fn(yb, o, m)
        fwd[key] = torch.cat([o.double().cpu().flatten(),
                              loss.double().cpu().reshape(1)])
        bundle = ModelBundle(m, (40, 256, 2), cfg, where,
                             needs_dropout_gen=True)
        grad_fn, update_fn = make_grad_update(bundle, loss_fn)
        grads, _ = grad_fn(m, (xb, yb), torch.Generator(device=where))
        grad[key] = [g.double().cpu() for g in grads]
        before = [p.detach().clone() for p in m.parameters()]
        update_fn(TrainState(m, make_optimizer(cfg, m.parameters())), grads)
        # every tensor with a gradient moves (a dropped block's do not)
        wrong = [n for n, p, b, g in zip(names, m.parameters(), before,
                                         grads)
                 if torch.equal(p, b) == bool(g.any())]
        if wrong:
            raise AssertionError(f'density step on {key}: {wrong} moved '
                                 'without a gradient or stayed with one')
        if key == 'f64':
            continue
        # AdaBelief in float64 from this copy's weights and gradients
        ref = [torch.nn.Parameter(b.double().cpu()) for b in before]
        for r, g in zip(ref, grad[key]):
            r.grad = g
        make_optimizer(cfg, ref).step()
        eps = torch.finfo(torch.float32).eps
        step_gap[key] = max(float(((p.detach().double().cpu() - r).abs()
                                   / (eps * (r.abs() + cfg.lr))).max())
                            for p, r in zip(m.parameters(), ref))
    peak = max(float(r.abs().max()) for r in grad['f64'])
    leaf = {}
    for k in ('cpu', 'card'):
        leaf[k] = max((float((g - r).abs().max() / r.abs().max()), n)
                      for n, g, r in zip(names, grad[k], grad['f64'])
                      if r.abs().max() >= DENSITY_LEAF_FLOOR * peak)
    gaps = {'forward': {}, 'gradient': {}}
    for k in ('cpu', 'card'):
        gaps['forward'][k] = float((fwd[k] - fwd['f64']).abs().max()
                                   / fwd['f64'].abs().max())
        gaps['gradient'][k] = max(float((g - r).abs().max())
                                  for g, r in zip(grad[k], grad['f64'])) / peak
    gaps['worst_leaf'] = {k: {'gap': v[0], 'tensor': v[1]}
                          for k, v in leaf.items()}
    gaps['step_ulps'] = step_gap
    log('card vs CPU density B0, small input: forward and loss and the '
        'step\'s gradients (over the peak, and the worst tensor over its '
        'own peak), gaps to float64; the update against float64 AdaBelief '
        f'on the same gradients, in float32 epsilons {json.dumps(gaps)}')
    for what, got, limit in (
            ('forward', gaps['forward']['card'], SCORE_TOL),
            ('gradient', gaps['gradient']['card'], DENSITY_GRAD_TOL),
            ('worst tensor gradient', leaf['card'][0], DENSITY_LEAF_TOL),
            ('AdaBelief update', step_gap['card'], DENSITY_STEP_ULPS)):
        if not got <= limit:
            raise AssertionError(f'card density {what} beyond the '
                                 f'tolerance {limit}: {gaps}')
    return {'density_gaps': gaps}


def density_main_path(banks) -> dict:
    """Phase 5f: the density trainer's defaults (``density_config``) on
    float32 banks built for 2,048 frames: ``TrainLoop(loss_fn=...)`` over
    ``DevicePipeline(variant='density')`` for 5 training steps and 1
    validation step, the float32 magnitude kernel once a batch and no
    other kernel, finite logs with cos_sim as the only metric, stochastic
    depth drawn; then 2 steps through ``FeatureFn(variant='density',
    fused_mel=True)``, the float32 mel kernel once a batch; the fused and
    unfused features of one generator state; then the step, the batch
    pipeline and the model step timed (``wall_ms``, as phase 6 times the
    others; the step graphed, ``density_step_ms``, then eager,
    ``eager_density_step_ms``) and the peak device memory above the earlier
    phases'."""
    start = time.perf_counter()
    ns = density_args()
    cfg = trainer.to_config(ns)
    res = {}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loop = TrainLoop(get_density_model(cfg, seed=cfg.seed), seed=cfg.seed,
                     loss_fn=trainer.make_loss_fn(ns))
    params = list(loop.state.module.parameters())
    res['density_params'] = sum(p.numel() for p in params)
    res['density_tensors'] = len(params)
    pipes = [iter(DevicePipeline(banks, cfg, training, variant='density',
                                 n_classes=ns.n_classes))
             for training in (True, False)]
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    hist = loop.fit(pipes[0], epochs=1, steps_per_epoch=DENSITY_STEPS,
                    validation_iter=pipes[1],
                    validation_steps=DENSITY_VAL_STEPS, verbose=0)
    torch.cuda.synchronize()
    # the first steps at each conv shape include cuDNN's algorithm search
    res['density_first_fit_s'] = time.perf_counter() - t0
    launches = {'unfused': dict(cuda.LAUNCHES)}
    check_launches('density B4, float32 banks', launches['unfused'],
                   {KERNELS[torch.float32][0]: DENSITY_STEPS
                    + DENSITY_VAL_STEPS})
    logs = hist[0]
    if set(logs) != {'loss', 'cos_sim', 'val_loss', 'val_cos_sim', 'time'} \
            or not all(map(math.isfinite, logs.values())):
        raise AssertionError(f'density logs {logs}')
    if torch.equal(loop.gen.get_state(), loop.dropout_gen(0).get_state()):
        raise AssertionError('density: stochastic depth drew nothing')
    res['density_logs'] = logs
    fused = feature_iter(banks, cfg, fused_mel=True, variant='density')
    cuda.reset_launch_counts()
    hist = loop.fit(fused, epochs=1, steps_per_epoch=DENSITY_FUSED_STEPS,
                    verbose=0)
    torch.cuda.synchronize()
    launches['fused'] = dict(cuda.LAUNCHES)
    check_launches('density B4 fused mel, float32 banks', launches['fused'],
                   {MEL_KERNELS[torch.float32]: DENSITY_FUSED_STEPS})
    if not math.isfinite(hist[0]['loss']):
        raise AssertionError(f'density fused: {hist[0]}')
    res['density_launches'] = launches
    # one batch of each path from the same generator state
    out = []
    for fused_mel in (False, True):
        gen = torch.Generator(device=banks.backgrounds.flat.device)
        out.append(FeatureFn(cfg, fused_mel=fused_mel, variant='density')(
            gen.manual_seed(7), banks))
    (xu, yu), (xf, yf) = out
    torch.testing.assert_close(xf, xu, rtol=1e-4, atol=1e-5)
    if not torch.equal(yf, yu) or xu.shape != (cfg.batch_size, cfg.n_mels,
                                                cfg.n_frame, 2) \
            or yu.shape != (cfg.batch_size, cfg.n_frame // 32, 3):
        raise AssertionError(f'density fused vs unfused: {xu.shape} '
                             f'{yu.shape}, labels equal '
                             f'{torch.equal(yf, yu)}')
    res['density_fused_vs_unfused_max_abs'] = float((xf - xu).abs().max())
    it = pipes[0]
    graphed = loop.train_step
    for key, step in (('density_step_ms', graphed),
                      ('eager_density_step_ms', graphed.plain)):
        loop.train_step = step
        res[key] = wall_ms(lambda: loop.run_epoch(
            it, DENSITY_TIMED_STEPS, training=True), 1) / DENSITY_TIMED_STEPS
    loop.train_step = graphed
    res['density_pipeline_ms'] = wall_ms(lambda: next(it), 10)
    batch = next(it)
    res['density_model_step_ms'] = wall_ms(
        lambda: loop.train_step(loop.state, batch, loop.gen), 10)
    res['density_peak_gib'] = (torch.cuda.max_memory_allocated()
                               - base) / 2**30
    if '--profile' in sys.argv:
        profile_steps(loop, it, 5, 'DENSITY_PROFILE')
    res['density_5f_s'] = time.perf_counter() - start
    log(f'density main path: {json.dumps(res)}')
    log(f'phase 5f: {res["density_5f_s"]:.3f} s')
    return res


def density_cli_chain(d: str) -> dict:
    """Phase 7e, in the CLI chain's directory ``d``: ``cli.trainer`` at its
    defaults with ``--n_chan 2 --bank_dtype int8`` for 3 epochs of 2
    steps, the int8 magnitude kernel once a batch; ``{name}.h5``,
    ``_SWA.h5`` and a 3-row ``{name}.log`` of cos_sim only; then
    ``--pretrain True`` for 2 epochs, which loads ``{name}.h5`` and takes
    ReduceLROnPlateau. Both runs timed."""
    start = time.perf_counter()
    files = Config()
    base = ['--datapath', d, '--bank_dtype', 'int8', '--steps_per_epoch',
            str(SE_CLI_STEPS)]
    for flag in ('background_sounds', 'voices', 'labels', 'noises',
                 'test_background_sounds', 'test_voices', 'test_labels'):
        base += [f'--{flag}', getattr(files, flag)]
    res = {'density_cli_s': [], 'density_int8_launches': []}
    for epochs, extra in ((CLI_EPOCHS, []),
                          (DENSITY_PRETRAIN_EPOCHS, ['--pretrain', 'True'])):
        batches = epochs * (SE_CLI_STEPS + CLI_VAL_STEPS)
        with contextlib.redirect_stdout(Tee(sys.stdout)) as out:
            run, counts, secs = run_cli(
                ['--name', 'dens', '--n_chan', '2', '--epochs', str(epochs)]
                + base + extra, 'synth_mag_int8', batches, main=trainer.main)
        res['density_cli_s'].append(secs)
        res['density_int8_launches'].append(counts)
        for f in (run + '.h5', run + '_SWA.h5', run + '.log'):
            if not os.path.exists(f):
                raise AssertionError(f'missing {f}')
        with open(run + '.log') as f:
            rows = f.read().strip().splitlines()
        header = rows[0].split(',')
        if len(rows) != 1 + CLI_EPOCHS + (epochs if extra else 0) \
                or not {'cos_sim', 'val_cos_sim'} <= set(header) \
                or {'er', 'f1_score', 'val_er'} & set(header):
            raise AssertionError(f'{run}.log: {rows}')
        if extra and 'loaded pretrained model' not in out.getvalue():
            raise AssertionError('the pretrain run did not load its weights')
    res['density_cli_batches'] = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    res['density_7e_s'] = time.perf_counter() - start
    log(f'phase 7e: {res["density_7e_s"]:.3f} s')
    return res


def bf16_cli_chain(d: str) -> dict:
    """Phase 7f, in the CLI chain's directory ``d``: ``cli.sj_train`` with
    vad v8, ``--compute_dtype bfloat16 --bank_dtype int8`` for 3 epochs of
    5 steps, the int8 magnitude kernel once a batch (63 times), its trio,
    then ``cli.eval --p --compute_dtype bfloat16``, 6 finite ERs; one
    epoch each of ``--loss focal --optimizer sgd`` and ``--loss MSE
    --mse_multiplier 8 --optimizer rmsprop`` on float32 banks (21
    float32 magnitude launches each), each with a finite loss and moved
    weights; and ``cli.trainer --compute_dtype bfloat16`` at its defaults
    with ``--n_chan 2 --bank_dtype int8`` for 2 epochs of 1 step (one
    epoch folds no SWA and raises ``NO_SWA_ERROR``, as in JAX), 34 int8
    launches, ``{name}.h5`` and ``_SWA.h5``. Every checkpoint is float32."""
    start = time.perf_counter()
    res = {}
    base = ['--model_type', 'vad', '--v', '8', '--n_chan', '2',
            '--datapath', d]
    batches = CLI_EPOCHS * (CLI_STEPS + CLI_VAL_STEPS)
    run, res['bf16_cli_launches'], res['bf16_cli_s'] = run_cli(
        base + ['--name', 'bf16c', '--compute_dtype', 'bfloat16',
                '--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
                '--steps_per_epoch', str(CLI_STEPS)], 'synth_mag_int8',
        batches)
    check_trio(run)
    for suffix in ('.h5', '_SWA.h5', '_sample.h5'):
        if {t.dtype for t in load_weights(run + suffix).values()} != \
                {torch.float32}:
            raise AssertionError(f'{run}{suffix} is not float32')
    res['bf16_cli_batches'] = batches
    res['bf16_ers'] = eval_cli.main(['--name', run, '--p',
                                     '--compute_dtype', 'bfloat16'])
    torch.cuda.synchronize()
    if len(res['bf16_ers']) != 6 or not all(map(math.isfinite,
                                                res['bf16_ers'])):
        raise AssertionError(f'bf16 eval CLI ERs: {res["bf16_ers"]}')
    init = get_model(Config(model_type='vad', v=8)).module.state_dict()
    res['loss_optim'] = {}
    for name, flags in (
            ('focal_sgd', ['--loss', 'focal', '--optimizer', 'sgd']),
            ('mse_rmsprop', ['--loss', 'MSE', '--mse_multiplier', '8',
                             '--optimizer', 'rmsprop'])):
        batches = CLI_STEPS + CLI_VAL_STEPS
        run, counts, secs = run_cli(
            base + ['--name', name, '--epochs', '1', '--steps_per_epoch',
                    str(CLI_STEPS)] + flags, KERNELS[torch.float32][0],
            batches)
        with open(run + '.csv') as f:
            row = list(csv.DictReader(f))[-1]
        w = load_weights(run + '.h5')
        moved = [k for k in init if 'running' not in k
                 and not torch.equal(init[k], w[k].to(init[k].device))]
        r = res['loss_optim'][name] = dict(
            loss=float(row['loss']), val_loss=float(row['val_loss']),
            moved_tensors=len(moved), launches=counts, seconds=secs)
        if not math.isfinite(r['loss']) or not moved:
            raise AssertionError(f'{name}: {r}')
    files = Config()
    argv = ['--name', 'dens16', '--n_chan', '2', '--compute_dtype',
            'bfloat16', '--bank_dtype', 'int8', '--epochs', '2',
            '--steps_per_epoch', '1', '--datapath', d]
    for flag in ('background_sounds', 'voices', 'labels', 'noises',
                 'test_background_sounds', 'test_voices', 'test_labels'):
        argv += [f'--{flag}', getattr(files, flag)]
    batches = 2 * (1 + CLI_VAL_STEPS)
    run, res['bf16_density_launches'], res['bf16_density_s'] = run_cli(
        argv, 'synth_mag_int8', batches, main=trainer.main)
    res['bf16_density_batches'] = batches
    for suffix in ('.h5', '_SWA.h5'):
        if {t.dtype for t in load_weights(run + suffix).values()} != \
                {torch.float32}:
            raise AssertionError(f'{run}{suffix} is not float32')
    res['bf16_7f_s'] = time.perf_counter() - start
    log(f'phase 7f: {res["bf16_7f_s"]:.3f} s')
    return res


def gpu_ms(fn, arg_list, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` calls cycling
    through ``arg_list``. The card first sleeps while the host queues
    every call, so the events time the device work, not Python."""
    fn(*arg_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(*arg_list[i % len(arg_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Host milliseconds per call, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def small_reference_check(dev) -> dict:
    """The port on the card against the port on the CPU, on a small
    input: the same draws, masks and weights on both; then int8 synthesis
    on the same draws."""
    cfg = Config(model_type='vad', v=8, n_mels=32, n_frame=64, batch_size=4)
    src = sources(3, 3, (20, 90), 6, (10, 40), 3, (8, 20))
    cpu, gpu = torch.device('cpu'), dev
    banks = {d: build_banks(*src, n_frame=64, device=d) for d in (cpu, gpu)}
    draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 4, 64)
    gdraws = mixture.Draws(*(x.to(gpu) if torch.is_tensor(x) else x
                             for x in draws))
    mag_c, y_c = mixture.synthesize(banks[cpu], draws)
    mag_g, y_g = mixture.synthesize(banks[gpu], gdraws)
    synth_diff = float((mag_g.cpu() - mag_c).abs().max())
    if synth_diff != 0.0 or not torch.equal(y_g.cpu(), y_c):
        raise AssertionError(f'card vs CPU synthesis: max diff {synth_diff}')
    gen = torch.Generator().manual_seed(6)
    tmask = batch_mask_keep(gen, 4, 64, max_mask_size=24, n_mask=6)
    fmask = batch_mask_keep(gen, 4, 257, max_mask_size=16, n_mask=1)
    x_c, l_c = FeatureFn(cfg, device=cpu).features(mag_c, y_c, tmask, fmask)
    x_g, l_g = FeatureFn(cfg, device=gpu).features(
        mag_g, y_g, tmask.to(gpu), fmask.to(gpu))
    feat_err = float((x_g.cpu() - x_c).abs().mean())
    if feat_err > 1e-5 or not torch.equal(l_g.cpu(), l_c):
        raise AssertionError(f'card vs CPU features: mean abs {feat_err}')
    torch.manual_seed(7)
    m_c = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=32).train()
    m_g = VADModel(v=8, base_fsize=8, td_dim=32, n_mels=32).to(gpu).train()
    m_g.load_state_dict(m_c.state_dict())
    with torch.no_grad():
        loss_c = float(binary_crossentropy(l_c, m_c(x_c)))
        loss_g = float(binary_crossentropy(l_g, m_g(x_g)))
    if not math.isclose(loss_g, loss_c, rel_tol=1e-5):
        raise AssertionError(f'card vs CPU loss: {loss_g} vs {loss_c}')
    # 4b: int8 banks, the same draws
    q = {d: build_banks(*src, n_frame=64, flat_dtype='int8', device=d)
         for d in (cpu, gpu)}
    qmag_c, _ = mixture.synthesize(q[cpu], draws)
    qmag_g, _ = mixture.synthesize(q[gpu], gdraws)
    if qmag_g.dtype != torch.bfloat16 or not torch.equal(qmag_g.cpu(),
                                                         qmag_c):
        raise AssertionError('card vs CPU int8 synthesis differ: max diff '
                             f'{float((qmag_g.cpu() - qmag_c).abs().max())}')
    return dict(synth_max_abs=synth_diff, logmel_mean_abs=feat_err,
                loss_gpu=loss_g, loss_cpu=loss_c, int8_synth_max_abs=0.0)


def se_reference_check(dev) -> dict:
    """Phase 4c: the se path on the card against the CPU on a small input
    (batch 2, 32 frames, the full-width cascade). Synthesis, targets and
    features bit for bit in each bank dtype, on the same draws; then one
    training-mode forward of the pretrain cascade and ``se_loss`` on the
    float32 features, the card's float32 held to a float64 CPU copy within
    ``SCORE_TOL`` of each output's peak or 10 times the CPU float32's
    distance (phase 8's rule)."""
    cpu = torch.device('cpu')
    src = sources(4, 3, (40, 90), 6, (10, 40), 3, (8, 20))
    feats = {}
    for name in FLAT_DTYPES:
        banks = {d: build_banks(*src, n_frame=32, flat_dtype=name, device=d)
                 for d in (cpu, dev)}
        draws = mixture.draw(torch.Generator().manual_seed(5), banks[cpu], 2,
                             32)
        gdraws = mixture.Draws(*(x.to(dev) if torch.is_tensor(x) else x
                                 for x in draws))
        out = {}
        for d, dr in ((cpu, draws), (dev, gdraws)):
            spec, targets = mixture.synthesize_se(banks[d], dr)
            x, y = speech_enhancement_preprocess(spec, targets)
            out[d] = [spec, *targets, x, *label_downsample(y, 32)]
        for c, g in zip(out[cpu], out[dev]):
            if c.dtype != g.dtype or not torch.equal(g.cpu(), c):
                raise AssertionError(f'card vs CPU se synthesis ({name}): '
                                     f'max diff '
                                     f'{float((g.cpu() - c).abs().max())}')
        if name == 'float32':
            feats = out
    m_c = SECascade(pretrain=True)
    m_c.reset_parameters(torch.Generator().manual_seed(8))
    models = {'cpu': m_c, 'card': copy.deepcopy(m_c).to(dev),
              'f64': copy.deepcopy(m_c).double()}
    res = {}
    with torch.no_grad():
        for key, m in models.items():
            where = cpu if key != 'card' else dev
            dt = torch.float64 if key == 'f64' else torch.float32
            x = feats[where][4].to(dt)
            y = tuple(t.to(dt) for t in feats[where][5:])
            outs = m.train()(x)
            res[key] = [o.double().cpu() for o in outs] + [
                se_loss(y, outs)[0].double().cpu().reshape(1)]
    gaps = {}
    for key in ('cpu', 'card'):
        gaps[key] = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(res[key], res['f64']))
    log(f'card vs CPU se, small input: synthesis, targets and features '
        f'equal; forward and loss gap to float64 over the peak '
        f'{json.dumps(gaps)}')
    if gaps['card'] > max(SCORE_TOL, 10 * gaps['cpu']):
        raise AssertionError('card se forward beyond the tolerance')
    return dict(se_forward_gap_cpu=gaps['cpu'],
                se_forward_gap_card=gaps['card'])


def se_main_path(banks) -> dict:
    """Phase 5b: se v9 at full width, pretrain then finetune from its
    weights, through ``get_model``, ``DevicePipeline`` and
    ``TrainLoop.fit``, each run's launch counts set to 0 just before it
    and read just after. Returns the pretrain loop and its iterator for
    phase 6, and the results."""
    res = {'se_launches': {}, 'se_batches': 0}
    weights, out = None, None
    for pretrain, frozen in ((True, 'vad.'), (False, 'se.')):
        cfg = Config(model_type='se', v=9, pretrain=pretrain)
        loop = TrainLoop(get_model(cfg))
        if weights is not None:
            loop.set_weights(weights)
        if pretrain:
            res['se_params'] = sum(p.numel()
                                   for p in loop.state.module.parameters())
        before = loop.get_weights()
        train_it = iter(DevicePipeline(banks, cfg))
        val_it = iter(DevicePipeline(banks, cfg, training=False))
        cuda.reset_launch_counts()
        hist = loop.fit(train_it, epochs=1, steps_per_epoch=SE_STEPS,
                        validation_iter=val_it, validation_steps=SE_VAL_STEPS)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        phase = 'pretrain' if pretrain else 'finetune'
        log(f'se {phase} launches: {json.dumps(launches)}')
        n = SE_STEPS + SE_VAL_STEPS
        if launches != {'synth_se_f32': n}:
            raise AssertionError(f'se {phase}: {launches} for {n} batches')
        for k, v in launches.items():
            res['se_launches'][k] = res['se_launches'].get(k, 0) + v
        res['se_batches'] += n
        logs = hist[0]
        res[f'se_{phase}_logs'] = logs
        names = ('loss', 'class_loss', 'speech_loss', 'noise_loss', 'val_loss',
                 'val_class_loss', 'val_speech_loss', 'val_class_er')
        if not all(math.isfinite(logs[k]) for k in names):
            raise AssertionError(f'se {phase}: non-finite logs {logs}')
        weights = loop.get_weights()
        for k, v in weights.items():
            if torch.equal(v, before[k]) != k.startswith(frozen):
                raise AssertionError(f'se {phase}: {k} '
                                     + ('moved' if k.startswith(frozen)
                                        else 'did not move'))
        if pretrain:
            out = loop, train_it
    return out + (res,)


def model_step_ms(benchmark: bool, reps: int = 10) -> float:
    """vad v8's training step at full width on one fixed batch, with
    ``cudnn.benchmark`` as given, in this process. cuDNN keeps the
    algorithms it has chosen for a shape for the life of the process and
    consults them even with the flag off, so each setting needs a fresh
    process."""
    cfg = Config(model_type='vad', v=8)
    banks = build_banks(*sources(0, 4, 600, 16, (40, 130), 8, (20, 100)),
                        n_frame=cfg.n_frame)
    batch = next(iter(DevicePipeline(banks, cfg)))
    loop = TrainLoop(get_model(cfg))
    # after the entry points, which turn it on
    torch.backends.cudnn.benchmark = benchmark
    for _ in range(3):
        loop.train_step(loop.state, batch)
    return wall_ms(lambda: loop.train_step(loop.state, batch), reps)


def cudnn_ab() -> dict:
    """The model step with cuDNN's per-shape algorithm timing off and on,
    each in a fresh process, in the order off, on, on, off."""
    res = {'off': [], 'on': []}
    for flag in ('off', 'on', 'on', 'off'):
        out = subprocess.run(
            [sys.executable, __file__, '--model-step', flag],
            capture_output=True, text=True, check=True, timeout=300).stdout
        res[flag].append(json.loads(out.strip().splitlines()[-1])['ms'])
    return res


def profile_steps(loop, it, steps: int, label: str = 'PROFILE') -> None:
    """torch.profiler over ``steps`` training steps: device time by kernel
    and the card's busy share of the wall time, printed on a ``label``
    line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run_epoch(it, steps, training=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events_ = prof.key_averages()
    attr = ('self_device_time_total' if hasattr(events_[0],
                                                'self_device_time_total')
            else 'self_cuda_time_total')
    device = [e for e in events_
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the optimizer's annotated range spans its kernels and the gaps
    # between them; the rest are kernels
    opt_us = sum(getattr(e, attr) for e in device
                 if e.key.startswith('Optimizer.step'))
    rows = sorted(((getattr(e, attr), e.key, e.count) for e in device
                   if getattr(e, attr) > 0
                   and not e.key.startswith('Optimizer.step')), reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f'profile: {steps} steps, wall {wall * 1e3:.3f} ms, kernel time '
        f'{busy_us / 1e3:.3f} ms, optimizer range {opt_us / 1e3:.3f} ms')
    for us, key, count in rows[:25]:
        log(f'  {us / 1e3:10.3f} ms  {count:6d}x  {key[:90]}')
    log(label + ' ' + json.dumps({
        'steps': steps, 'wall_ms': wall * 1e3, 'kernel_ms': busy_us / 1e3,
        'optimizer_range_ms': opt_us / 1e3,
        'synth_ms': sum(r[0] for r in rows if 'synth_' in r[1]) / 1e3}))


def write_dev_set(d: str, n_clips: int = 6, seconds: float = 60.0,
                  seed: int = 0) -> dict:
    """``n_clips`` two-channel 16 kHz int16 WAVs of noise with tone events
    of three classes (300, 800 and 1,500 Hz, 0.8-2 s each), and the
    ``sample_answer.json`` that lists the events. Returns the answers."""
    rng = np.random.default_rng(seed)
    answers = {}
    for i in range(n_clips):
        n = int(seconds * SR)
        sig = 0.05 * rng.standard_normal((n, 2))
        evs, t = [], float(rng.uniform(0.5, 2.0))
        while t + 2.5 < seconds:
            cls, dur = int(rng.integers(0, 3)), float(rng.uniform(0.8, 2.0))
            s0, s1 = int(t * SR), int((t + dur) * SR)
            tone = np.sin(2 * np.pi * (300, 800, 1500)[cls]
                          * np.arange(s1 - s0) / SR)
            sig[s0:s1] += 0.2 * tone[:, None]
            evs.append([cls, round(t, 3), round(t + dur, 3)])
            t += dur + float(rng.uniform(1.0, 4.0))
        write_wav(os.path.join(d, f'dev{i:02d}.wav'),
                  (np.clip(sig, -1, 1) * 32767).astype('<i2'))
        answers[f'dev{i:02d}'] = evs
    with open(os.path.join(d, 'sample_answer.json'), 'w') as f:
        json.dump({'task2_answer': answers}, f)
    return answers


def write_wav(path: str, pcm) -> None:
    """int16 [n, chan] -> 16-bit PCM WAV at 16 kHz."""
    with wave.open(path, 'wb') as f:
        f.setnchannels(pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def write_spec_sets(d: str, train_src, test_src) -> None:
    """The spec sets as pickles (labels as .npy) under sj_train's default
    file names; the noises are shared by both sets, as in the CLI."""
    cfg = Config()
    bgs, voices, labels, noises = train_src
    tbgs, tvoices, tlabels, _ = test_src
    for name, obj in ((cfg.background_sounds, bgs), (cfg.voices, voices),
                      (cfg.noises, noises),
                      (cfg.test_background_sounds, tbgs),
                      (cfg.test_voices, tvoices)):
        with open(os.path.join(d, name), 'wb') as f:
            pickle.dump(list(obj), f, protocol=pickle.HIGHEST_PROTOCOL)
    np.save(os.path.join(d, cfg.labels), labels)
    np.save(os.path.join(d, cfg.test_labels), tlabels)


def run_cli(argv, kernel: str, batches: int, main=sj_train.main):
    """``main(argv)`` (by default ``cli.sj_train``'s) with the launch
    counts set to 0 just before and read just after; ``kernel`` must have
    launched once a batch. Returns (run name, counts, wall seconds)."""
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    run = main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(cuda.LAUNCHES)
    log(f'cli {kernel}: {json.dumps(counts)} in {secs:.3f} s')
    if counts.get(kernel, 0) != batches:
        raise AssertionError(f'{kernel} ran {counts.get(kernel, 0)} times '
                             f'for {batches} batches')
    return run, counts, secs


def check_trio(run: str) -> None:
    for suffix in ('.h5', '_SWA.h5', '_sample.h5'):
        if not os.path.exists(run + suffix):
            raise AssertionError(f'missing checkpoint {run}{suffix}')


def se_cli_chain(d: str) -> dict:
    """Phase 7b, in the CLI chain's directory ``d``: se v9 pretrain on
    int8 banks, finetune on bfloat16 banks from its checkpoint, then the
    eval CLI on the finetuned ``_SWA.h5``."""
    res = {}
    base = ['--model_type', 'se', '--v', '9', '--n_chan', '2',
            '--datapath', d, '--epochs', str(CLI_EPOCHS),
            '--steps_per_epoch', str(SE_CLI_STEPS)]
    batches = CLI_EPOCHS * (SE_CLI_STEPS + CLI_VAL_STEPS)
    pre, res['se_int8_launches'], res['se_int8_cli_s'] = run_cli(
        base + ['--bank_dtype', 'int8', '--pretrain', 'True'],
        'synth_se_int8', batches)
    check_trio(pre)
    # the finetune run loads {run}.h5 under its own name, which has no
    # '_weight' (sj_train.py:467-469); the reference's bool flag reads any
    # value of --pretrain as True, so finetuning leaves it out
    run = pre[:-len('_weight')]
    shutil.copy(pre + '.h5', run + '.h5')
    got, res['se_bf16_launches'], res['se_bf16_cli_s'] = run_cli(
        base + ['--bank_dtype', 'bfloat16'], 'synth_se_bf16', batches)
    if got != run:
        raise AssertionError(f'finetune run {got}, expected {run}')
    check_trio(run)
    pre_w, ft_w = load_weights(pre + '.h5'), load_weights(run + '.h5')
    moved = {k for k in pre_w if not torch.equal(pre_w[k], ft_w[k])}
    if not moved or any(k.startswith('se.') for k in moved):
        raise AssertionError('finetune must train the head and leave the '
                             'U-Net bit-identical')
    res['se_cli_batches'] = batches
    t0 = time.perf_counter()
    ers = eval_cli.main(['--name', run + '_SWA', '--p'])
    torch.cuda.synchronize()
    res['se_eval_s'] = time.perf_counter() - t0
    if len(ers) != 6 or not all(map(math.isfinite, ers)):
        raise AssertionError(f'se eval CLI ERs: {ers}')
    res['se_ers'] = ers
    log(f'se eval CLI, 6 x 60 s: ERs {ers} in {res["se_eval_s"]:.3f} s')
    return res


def cli_chain(dev, train_src, test_src, chan4_model) -> dict:
    """Phases 7, 8 and 7b-7f, in a temporary directory that is removed
    after."""
    res = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as d:
        os.chdir(d)
        try:
            write_spec_sets(d, train_src, test_src)
            answers = write_dev_set(d)
            base = ['--model_type', 'vad', '--v', '8', '--n_chan', '2',
                    '--datapath', d]
            batches = CLI_EPOCHS * (CLI_STEPS + CLI_VAL_STEPS)
            run, counts, res['int8_cli_s'] = run_cli(
                base + ['--bank_dtype', 'int8', '--epochs', str(CLI_EPOCHS),
                        '--steps_per_epoch', str(CLI_STEPS)],
                'synth_mag_int8', batches)
            res['int8_launches'], res['int8_batches'] = counts, batches
            check_trio(run)
            with open(run + '.csv') as f:
                rows = f.read().strip().splitlines()
            if len(rows) != 1 + CLI_EPOCHS:
                raise AssertionError(f'{run}.csv has {len(rows)} lines')
            t0 = time.perf_counter()
            ers = eval_cli.main(['--name', run, '--p'])
            torch.cuda.synchronize()
            res['eval_s'] = time.perf_counter() - t0
            if len(ers) != 6 or not all(map(math.isfinite, ers)):
                raise AssertionError(f'eval CLI ERs: {ers}')
            res['ers'] = ers
            log(f'eval CLI, 6 x 60 s: ERs {ers} in {res["eval_s"]:.3f} s')
            _, counts, res['bf16_cli_s'] = run_cli(
                base + ['--bank_dtype', 'bfloat16', '--name', 'bf16',
                        '--epochs', '1', '--steps_per_epoch',
                        str(CLI_STEPS)],
                'synth_mag_bf16', CLI_STEPS + CLI_VAL_STEPS)
            res['bf16_launches'] = counts
            res['bf16_batches'] = CLI_STEPS + CLI_VAL_STEPS
            res.update(card_vs_cpu_eval(dev, run, answers))
            res.update(se_cli_chain(d))
            res.update(chan_cli_chain(d, chan4_model))
            res.update(eff_cli_chain(d))
            res.update(density_cli_chain(d))
            res.update(bf16_cli_chain(d))
            res.update(stream_resume_cli_chain(d))
            res['keras'] = keras_export_chain(d)
        finally:
            os.chdir(cwd)
    return res


def clip_windows(cfg, module, paths):
    """The model inputs (log-mel windows) of ``paths``, concatenated."""
    windows = []
    hook = module.register_forward_pre_hook(
        lambda mod, args: windows.append(args[0]))
    for path in paths:
        infer.clip_scores(cfg, module, path)
    hook.remove()
    return torch.cat(windows)


def event_bias_shift(z):
    """Per class, the output bias shift that puts the 0.5 threshold in the
    middle of the widest gap between the sorted logits ``z [n, C]`` with
    at least one and at most half of them above it, so that no logit lies
    near it, and that gap's width. A class whose widest such gap is under
    ``MIN_GAP`` (its logits hardly vary) is shifted 10 below its least
    logit instead, and predicts no event."""
    zs = torch.sort(z, dim=0).values
    n = zs.shape[0]
    gaps = zs[n // 2 + 1:] - zs[n // 2:-1]
    k = gaps.argmax(dim=0) + n // 2
    cols = torch.arange(zs.shape[1])
    mid = (zs[k, cols] + zs[k + 1, cols]) / 2
    width = gaps.amax(dim=0)
    return torch.where(width >= MIN_GAP, -mid, -zs[-1] - 10.0), width


def card_vs_cpu_eval(dev, run: str, answers: dict) -> dict:
    """Phase 8: ``run``'s _SWA.h5 on the card and on the CPU over the first
    2 dev clips cut to ``CUT_S`` seconds, made to predict events first.

    After a few steps the BN running statistics are still near their
    initial 0 and 1, so the eval-mode outputs hardly vary and predict no
    event. The statistics are therefore set to those of the whole dev
    set's windows (one training-mode forward on the card with momentum 0),
    and the output bias is shifted per class (:func:`event_bias_shift`).
    The CPU's model and a float64 copy of it get the same weights.

    Held, on the scores: the card's spectrogram against the CPU's within
    ``SCORE_TOL`` of the peak; the card's scores from the CPU's
    spectrogram against the float64 scores within ``SCORE_TOL`` of the
    peak, or within 10 times the distance of the CPU's float32 scores (a
    model whose outputs vary with its input amplifies float32 rounding,
    and the card's convolution algorithms round otherwise than the
    CPU's). Then each class's logits are scaled until those next to the
    threshold lie ``SHARP`` from it, so that every smoothed score lies at
    least 1/62 from 0.5, and held on the grids: end to end they may
    differ only at frames within ``SCORE_TOL`` of 0.5, must hold events
    and silence, and give identical ERs against the answers inside each
    clip."""
    cfg = Config(model_type='vad', v=8)
    paths = []
    for i in range(2):
        with wave.open(f'dev{i:02d}.wav', 'rb') as f:
            pcm = np.frombuffer(f.readframes(CUT_S * SR),
                                '<i2').reshape(-1, 2)
        paths.append(f'cut{i:02d}.wav')
        write_wav(paths[-1], pcm)
    card, cpu = (get_model(cfg, device=where).module
                 for where in (dev, torch.device('cpu')))
    card.load_state_dict(load_weights(run + '_SWA.h5'))
    x = clip_windows(cfg, card, [f'{name}.wav' for name in sorted(answers)])
    bns = [m for m in card.modules() if isinstance(m, BatchNorm)]
    momenta = [m.momentum for m in bns]
    logits = []
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.0
        card.train()(x)
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
        last = card.fcs[-1].dense
        hook = last.register_forward_hook(
            lambda mod, args, out: logits.append(out))
        card.eval()(clip_windows(cfg, card, paths))
        hook.remove()
        shift, widths = event_bias_shift(
            logits[-1].reshape(-1, last.out_features).cpu())
        last.bias += shift.to(dev)
    cpu.load_state_dict(card.state_dict())
    ref = copy.deepcopy(cpu).double()

    gap = dict.fromkeys(('spec', 'cpu_vs_f64', 'card_vs_f64', 'card_vs_cpu',
                         'end_to_end'), 0.0)
    # not held, printed: the card's scores are its own log-mel windows'
    # (the float64 and the CPU's scores share the CPU's), so apart, the
    # largest |card - CPU| of those windows and the model alone on the
    # card from the CPU's windows against float64 (ROADMAP C13)
    parts = {'windows_abs': 0.0, 'card_model_vs_f64': 0.0,
             'cpu_model_vs_f64': 0.0}
    specs = []
    for path in paths:
        spec = {'cpu': load_wav(path, device='cpu'),
                'card': load_wav(path, device=dev).cpu()}
        specs.append(spec)
        windows = {}
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, k=k: windows.setdefault(k, args[0]))
            for k, m in (('cpu', cpu), ('card', card))]
        scores = {
            'f64': infer.spec_to_scores(cfg, ref, spec['cpu']),
            'cpu': infer.spec_to_scores(cfg, cpu, spec['cpu']),
            'card': infer.spec_to_scores(cfg, card,
                                         spec['cpu'].to(dev)).cpu(),
            'card_e2e': infer.spec_to_scores(cfg, card,
                                             spec['card'].to(dev)).cpu()}
        for h in hooks:
            h.remove()
        with torch.no_grad():
            w = windows['cpu']
            out = {'f64': ref(w.double()), 'cpu': cpu(w),
                   'card': card(w.to(dev)).cpu()}
        parts['windows_abs'] = max(parts['windows_abs'], float(
            (windows['card'].cpu() - w).abs().max()))
        for k in ('cpu', 'card'):
            parts[f'{k}_model_vs_f64'] = max(
                parts[f'{k}_model_vs_f64'],
                float((out[k].double() - out['f64']).abs().max()
                      / out['f64'].abs().max()))
        peak = float(scores['f64'].abs().max())
        for key, a, b in (
                ('spec', spec['card'], spec['cpu']),
                ('cpu_vs_f64', scores['cpu'], scores['f64']),
                ('card_vs_f64', scores['card'], scores['f64']),
                ('card_vs_cpu', scores['card'], scores['cpu']),
                ('end_to_end', scores['card_e2e'], scores['cpu'])):
            ref_peak = float(b.abs().max()) if key == 'spec' else peak
            gap[key] = max(gap[key],
                           float((a - b).abs().max()) / ref_peak)
    log(f'card vs CPU eval, 2 clips of {CUT_S} s: logit gaps at the '
        f'threshold {widths.tolist()}, max abs gaps over the peak '
        f'{json.dumps(gap)}; apart, {json.dumps(parts)}')
    if gap['spec'] > SCORE_TOL:
        raise AssertionError('card vs CPU spectrogram beyond the tolerance')
    if gap['card_vs_f64'] > max(SCORE_TOL, 10 * gap['cpu_vs_f64']):
        raise AssertionError('card scores beyond the tolerance')

    scale = torch.where(widths >= MIN_GAP, 2 * SHARP / widths, 1.0)
    with torch.no_grad():
        for m in (card, cpu):
            m.fcs[-1].dense.weight *= scale.to(m.td.weight.device)[:, None]
            m.fcs[-1].dense.bias *= scale.to(m.td.weight.device)
    to_metric = events.output_to_metric(infer.HOP, SR)
    borderline, positive, nearest = 0, [], 0.5
    ers = {'card': [], 'cpu': []}
    for i, spec in enumerate(specs):
        scores = {'cpu': infer.spec_to_scores(cfg, cpu, spec['cpu']),
                  'card': infer.spec_to_scores(cfg, card,
                                               spec['card'].to(dev)).cpu()}
        grids = {k: (v >= 0.5).float().numpy() for k, v in scores.items()}
        dist = np.abs(scores['cpu'].numpy() - 0.5)
        differ = grids['card'] != grids['cpu']
        if (differ & (dist > SCORE_TOL)).any():
            raise AssertionError(f'clip {i}: card and CPU grids differ away '
                                 'from the 0.5 threshold')
        borderline += int(differ.sum())
        nearest = min(nearest, float(dist.min()))
        positive.append(float(grids['cpu'].mean()))
        gt = np.asarray([[c, t0, min(t1, CUT_S)] for c, t0, t1
                         in answers[f'dev{i:02d}'] if t0 < CUT_S])
        for k, g in grids.items():
            ers[k].append(events.get_er(gt, to_metric(
                *events.get_start_end_frame(g))))
    log(f'card vs CPU grids: positive share {positive}, nearest score to '
        f'0.5 at {nearest}, {borderline} frames differ, ERs {ers}')
    if not 0.0 < np.mean(positive) < 1.0:
        raise AssertionError(f'positive grid share per clip: {positive}')
    if ers['card'] != ers['cpu']:
        raise AssertionError(f'card vs CPU ERs: {ers}')
    for path in paths:              # the dev set is scored again in 7b
        os.remove(path)
    return dict(cut_ers=ers['card'], cut_max_rel_gap=gap, cut_parts=parts,
                cut_positive_share=positive, cut_nearest_to_half=nearest,
                borderline_frames=borderline)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if '--model-step' in argv:
        flag = argv[argv.index('--model-step') + 1]
        log(json.dumps({'ms': model_step_ms(flag == 'on')}))
        return 0
    run_start = time.perf_counter()
    dev = torch.device('cuda', 0)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')

    # 1. build
    secs = cuda.build(['synth', 'synth_mel'], verbose=True)
    log(f'build: {secs:.3f} s')

    # 2. banks at a realistic size, in the three bank dtypes
    t0 = time.perf_counter()
    src = sources(0, 32, 1875, 512, (40, 130), 128, (20, 100))
    banks = {name: build_banks(*src, n_frame=512, flat_dtype=name)
             for name in FLAT_DTYPES}
    torch.cuda.synchronize()
    # the same sources for the density trainer's 2,048-frame windows:
    # its backgrounds of 1,875 frames are wrapped
    banks2048 = {name: build_banks(*src, n_frame=2048, flat_dtype=name)
                 for name in FLAT_DTYPES}
    torch.cuda.synchronize()
    for name, bk in [*banks.items(), *((f'{k} (2,048 frames)', v)
                                       for k, v in banks2048.items())]:
        nbytes = sum(t.numel() * t.element_size() for b in
                     (bk.backgrounds, bk.voices, bk.noises)
                     for t in (b.flat, b.lens, b.pos_mask, b.flat_scale)
                     if t is not None)
        log(f'banks {name}: {nbytes / 2**30:.3f} GiB on the card')
    log(f'banks built in {time.perf_counter() - t0:.3f} s')

    # 3, 3b. each kernel against its plain version
    cfg = Config(model_type='vad', v=8)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_draws = [mixture.draw(gen, banks['float32'], cfg.batch_size,
                               cfg.n_frame, max_voices=cfg.max_voices,
                               max_noises=cfg.max_noises, snr=cfg.snr)
                  for _ in range(16)]
    # the density trainer's batches: 12 x 2,048 frames on the wrapped
    # backgrounds of banks2048, 10 voice and 6 noise slots
    dcfg = density_config()
    dgen = torch.Generator(device=dev).manual_seed(5)
    density_draws = [mixture.draw(dgen, banks2048['float32'],
                                  dcfg.batch_size, dcfg.n_frame,
                                  max_voices=dcfg.max_voices,
                                  max_noises=dcfg.max_noises, snr=dcfg.snr)
                     for _ in range(2)]
    cases = adversarial_cases(dev)
    errs = {}
    for name, dt in FLAT_DTYPES.items():
        e = {'main_path': max(max_abs_diff(mixture.synth_args(banks[name], d))
                              for d in main_draws[:4]),
             'density2048': max(max_abs_diff(
                 mixture.synth_args(banks2048[name], d))
                 for d in density_draws)}
        for case, args in cases.items():
            e[case] = max_abs_diff(args if dt == torch.float32
                                   else lowp_case(args, dt))
        errs[KERNELS[dt][0]] = e
    # 3c. the flat-complex kernels: the same draws and cases, and the se
    # triple's other two calls, and its voices-only call with every voice
    # slot inactive (nothing but the zero background); then the se triple
    # kernels, each output against the plain calls and the single-call
    # kernels
    for name, dt in FLAT_DTYPES.items():
        e = {'main_path': max(max_abs_diff(mixture.synth_args(banks[name], d),
                                           flat=True)
                              for d in main_draws[:4])}
        for case, args in cases.items():
            e[case] = max_abs_diff(args if dt == torch.float32
                                   else lowp_case(args, dt), flat=True)
        _, only_noise, only_voice = mixture.se_synth_args(banks[name],
                                                          main_draws[0])
        no_voice = (only_voice[:7] + (torch.zeros_like(only_voice[7]),)
                    + only_voice[8:])
        for case, args in (('se_only_noise', only_noise),
                           ('se_only_voice', only_voice),
                           ('se_no_voice', no_voice)):
            e[case] = max_abs_diff(args, flat=True)
        errs[FLAT_KERNELS[dt]] = e
        e = {'main_path': max(se_diff(mixture.synth_args(banks[name], d))
                              for d in main_draws[:4])}
        for case, args in cases.items():
            e[case] = se_diff(args if dt == torch.float32
                              else lowp_case(args, dt))
        full = mixture.synth_args(banks[name], main_draws[0])
        e['no_voice'] = se_diff(full[:7] + (torch.zeros_like(full[7]),)
                                + full[8:])
        errs[SE_KERNELS[dt]] = e
    # 3d. the fused mel kernels
    errs.update(mel_checks(dev, banks, main_draws, cases, banks2048))
    log('kernel vs plain, max abs diff: ' + json.dumps(errs))
    if any(v != 0.0 for e in errs.values() for v in e.values()):
        raise AssertionError('a synthesis kernel disagrees with its plain '
                             'version')

    # 4, 4b, 4c. the card against the CPU on a small input
    log('card vs CPU, small input: ' + json.dumps(small_reference_check(dev)))
    se_ref = se_reference_check(dev)
    mel_ref = mel_reference_check(dev)
    t0 = time.perf_counter()
    eff_ref = eff_reference_check(dev)
    log(f'phase 4e: {time.perf_counter() - t0:.3f} s')
    t0 = time.perf_counter()
    density_ref = density_reference_check(dev)
    density_ref['density_4f_s'] = time.perf_counter() - t0
    log(f'phase 4f: {density_ref["density_4f_s"]:.3f} s')
    t0 = time.perf_counter()
    bf16_ref = bf16_reference_check(dev)
    bf16_ref['bf16_4g_s'] = time.perf_counter() - t0
    log(f'phase 4g: {bf16_ref["bf16_4g_s"]:.3f} s')

    # 5. the main path
    f32_kernel = KERNELS[torch.float32][0]
    loop = TrainLoop(get_model(cfg))
    train_it = iter(DevicePipeline(banks['float32'], cfg))
    val_it = iter(DevicePipeline(banks['float32'], cfg, training=False))
    cuda.reset_launch_counts()
    hist = loop.fit(train_it, epochs=1, steps_per_epoch=TRAIN_STEPS,
                    validation_iter=val_it, validation_steps=VAL_STEPS)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    logs = hist[0]
    log('main path launches: ' + json.dumps(launches))
    if launches.get(f32_kernel, 0) != TRAIN_STEPS + VAL_STEPS:
        raise AssertionError(f'{f32_kernel} ran '
                             f'{launches.get(f32_kernel, 0)} times for '
                             f'{TRAIN_STEPS + VAL_STEPS} batches')
    if not all(math.isfinite(logs[k]) for k in ('loss', 'val_loss')):
        raise AssertionError(f'non-finite losses: {logs}')

    # 5b. the se slice's main path
    se_loop, se_train_it, se = se_main_path(banks['float32'])

    # 5c. this slice's main path: vad v9 through the fused mel kernel; 5d.
    # the channel maps through the flat-complex kernel
    v9_loop, v9_train_it, mel = mel_main_path(banks)
    chan4_model, chan = chan_main_path(banks)
    # 5e. this slice's main path: the eff family through kernel B1
    t0 = time.perf_counter()
    eff_loop, eff_train_it, eff = eff_main_path(banks['float32'])
    log(f'phase 5e: {time.perf_counter() - t0:.3f} s')
    # 5f. this slice's main path: the density trainer through B1 and B4
    density = density_main_path(banks2048['float32'])
    # 5g. this slice's main path: the fused step, graphed and plain
    fused_res = fused_checks(banks['float32'], banks2048['float32'])
    # 5h. this slice's main path: the fused step with bfloat16 models
    bf16_res = bf16_fused_checks(banks['float32'], banks2048['float32'])
    # 5i. this slice's main path: the graphed step on a rotation of chunk
    # banks; 5j. resume on the card, resident and mid-rotation
    stream_res, chunks = stream_checks(dev, banks['float32'])
    resume_res = resume_checks(banks['float32'], chunks)
    del chunks
    # 5k. the data-parallel mesh, two ranks on this card; utils.profiling
    mesh_dir = tempfile.mkdtemp(prefix='chip_smoke_5k_')
    try:
        mesh_res = mesh_checks(dev, banks['float32'],
                               fused_res['vad_v8']['fused_step_ms'],
                               mesh_dir)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    # 5m. the mesh steps as CUDA graphs over NCCL, a rank a card
    mesh_dir = tempfile.mkdtemp(prefix='chip_smoke_5m_')
    try:
        mesh_graph_res = mesh_graph_checks(mesh_dir)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    # 5l. this slice's main path: the graphed iterator and validation steps
    # of the density defaults, vad v8 and eff B0 v1, the graphed fused
    # eval step, sample_batch's routes
    iter_res = iter_graph_checks(banks, banks2048)
    del banks2048

    # 6. times: each kernel on the main path's draws (the flat-complex
    # ones on the full mix, the se triple on the same draws); then the
    # time of a launch of PyTorch's spin kernel for 0 cycles, an empty
    # kernel, timed the same way: a floor under the shortest kernels
    timing = {}
    for outputs, fn, plain, names in (
            (0, synthesize_magnitude, synthesize_magnitude_plain,
             {dt: KERNELS[dt][0] for dt in KERNELS}),
            (1, synthesize_flat, synthesize_flat_plain, FLAT_KERNELS),
            (3, synthesize_se, synthesize_se_plain, SE_KERNELS)):
        for name, dt in FLAT_DTYPES.items():
            args = [mixture.synth_args(banks[name], d) for d in main_draws]
            kernel_ms, plain_ms = [], []
            for which in ('plain', 'kernel', 'kernel', 'plain'):
                if which == 'kernel':
                    kernel_ms.append(gpu_ms(fn, args, 64))
                else:
                    plain_ms.append(gpu_ms(plain, args, 16))
            work = [synth_work(d, banks[name].backgrounds.flat.shape[-1], dt,
                               outputs > 0, max(outputs, 1))
                    for d in main_draws]
            nbytes = sum(w[0] for w in work) / len(work)
            flops = sum(w[1] for w in work) / len(work)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            timing[names[dt]] = dict(
                ms=sum(kernel_ms) / len(kernel_ms),
                plain_ms=sum(plain_ms) / len(plain_ms), bound_ms=bound_ms,
                bound_by=('bytes' if nbytes / HBM_BYTES_PER_S
                          >= flops / FP32_FLOPS else 'operations'))
            log(f'{names[dt]}: kernel {kernel_ms} ms, plain {plain_ms} ms, '
                f'{nbytes / 1e6:.3f} MB and {flops / 1e9:.4f} GFLOP per '
                f'call, bound {bound_ms * 1e3:.3f} us')
    empty_ms = [gpu_ms(torch.cuda._sleep, [(0,)], 256) for _ in range(2)]
    log(f'empty kernel launch: {empty_ms} ms')
    # the mel kernels on the main path's draws with training masks; bounds
    # over the band's columns and, beside them, over all columns
    mel_fn = FeatureFn(Config(model_type='vad', v=9), device=dev,
                       fused_mel=True)
    band = mel_fn.band
    mask_gen = torch.Generator(device=dev).manual_seed(3)
    masks = []
    for _ in main_draws:
        tmask, fmask = mel_fn.masks(mask_gen)
        masks.append((mel_fn.melm, tmask, fmask.repeat(1, 2)))
    for name, dt in FLAT_DTYPES.items():
        args = [mixture.synth_args(banks[name], d) + m
                for d, m in zip(main_draws, masks)]
        kernel_ms, plain_ms = [], []
        for which in ('plain', 'kernel', 'kernel', 'plain'):
            fn = synthesize_mel if which == 'kernel' else synthesize_mel_plain
            run = (lambda fn: lambda *a: fn(*a[:-3], melm=a[-3], tmask=a[-2],
                                            fmask=a[-1], band=band))(fn)
            if which == 'kernel':
                kernel_ms.append(gpu_ms(run, args, 64))
            else:
                plain_ms.append(gpu_ms(run, args, 16))
        width = banks[name].backgrounds.flat.shape[-1]
        work = {cols: [mel_work(d, width, dt, band, 80, cols == 'all')
                       for d in main_draws] for cols in ('band', 'all')}
        nbytes = {k: sum(w[0] for w in v) / len(v) for k, v in work.items()}
        flops = sum(w[1] for w in work['band']) / len(work['band'])
        bound_ms = max(nbytes['band'] / HBM_BYTES_PER_S,
                       flops / FP32_FLOPS) * 1e3
        timing[MEL_KERNELS[dt]] = dict(
            ms=sum(kernel_ms) / len(kernel_ms),
            plain_ms=sum(plain_ms) / len(plain_ms), bound_ms=bound_ms,
            bound_by=('bytes' if nbytes['band'] / HBM_BYTES_PER_S
                      >= flops / FP32_FLOPS else 'operations'),
            bound_ms_all_columns=nbytes['all'] / HBM_BYTES_PER_S * 1e3)
        log(f'{MEL_KERNELS[dt]}: kernel {kernel_ms} ms, plain {plain_ms} ms, '
            f'{nbytes["band"] / 1e6:.3f} MB over the band '
            f'({nbytes["all"] / 1e6:.3f} MB over all columns) and '
            f'{flops / 1e9:.4f} GFLOP per call, bound '
            f'{bound_ms * 1e3:.3f} us')

    batch = next(train_it)
    step_ms = wall_ms(lambda: loop.run_epoch(train_it, 20, training=True),
                      1) / 20
    pipe_ms = wall_ms(lambda: next(train_it), 20)
    model_ms = wall_ms(lambda: loop.train_step(loop.state, batch), 20)
    if '--profile' in argv:
        profile_steps(loop, train_it, 10)
        # the same model computing in bfloat16, eager, on the same batches
        bf16_loop = TrainLoop(get_model(cfg.replace(
            compute_dtype='bfloat16')))
        bf16_loop.run_epoch(train_it, 3, training=True)
        profile_steps(bf16_loop, train_it, 10, 'BF16_PROFILE')
        del bf16_loop
    if '--cudnn-ab' in argv:
        log('CUDNN model_step_ms, fresh process each: '
            + json.dumps(cudnn_ab()))
    del loop, train_it, val_it

    # the se v9 step (pretrain, float32 banks), timed as vad's
    se_batch = next(se_train_it)
    torch.cuda.reset_peak_memory_stats()     # phase 5e's runs reset it too
    se['se_step_ms'] = wall_ms(lambda: se_loop.run_epoch(
        se_train_it, SE_TIMED_STEPS, training=True), 1) / SE_TIMED_STEPS
    se['se_pipeline_ms'] = wall_ms(lambda: next(se_train_it), 10)
    se['se_model_step_ms'] = wall_ms(
        lambda: se_loop.train_step(se_loop.state, se_batch), 5)
    se['se_peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    if '--profile' in argv:
        profile_steps(se_loop, se_train_it, 5, 'SE_PROFILE')
    del se_loop, se_train_it, se_batch

    # the eff B0 v1 step, timed as vad's
    t0 = time.perf_counter()
    eff_batch = next(eff_train_it)
    eff['eff_step_ms'] = wall_ms(lambda: eff_loop.run_epoch(
        eff_train_it, 20, training=True), 1) / 20
    eff['eff_pipeline_ms'] = wall_ms(lambda: next(eff_train_it), 20)
    eff['eff_model_step_ms'] = wall_ms(
        lambda: eff_loop.train_step(eff_loop.state, eff_batch, eff_loop.gen),
        20)
    if '--profile' in argv:
        profile_steps(eff_loop, eff_train_it, 10, 'EFF_PROFILE')
    del eff_loop, eff_train_it, eff_batch
    log(f'phase 6, eff times: {time.perf_counter() - t0:.3f} s')

    # the v9 fused-mel step, timed as vad's; then the batch pipeline
    # through kernel B4 and through B1 plus the matmul mel, in turns
    v9_loop.run_epoch(v9_train_it, 3, training=True)
    mel['v9_step_ms'] = wall_ms(lambda: v9_loop.run_epoch(
        v9_train_it, 20, training=True), 1) / 20
    v9_batch = next(v9_train_it)
    mel['v9_model_step_ms'] = wall_ms(
        lambda: v9_loop.train_step(v9_loop.state, v9_batch), 20)
    if '--profile' in argv:
        profile_steps(v9_loop, v9_train_it, 10, 'V9_PROFILE')
    v9_cfg = Config(model_type='vad', v=9)
    pipes = {k: feature_iter(banks['float32'], v9_cfg, fused_mel=k)
             for k in (False, True)}
    for it in pipes.values():
        next(it)
    mel['pipeline_ms'], mel['fused_mel_pipeline_ms'] = [], []
    for fused in (False, True, True, False):
        mel['fused_mel_pipeline_ms' if fused else 'pipeline_ms'].append(
            wall_ms(lambda: next(pipes[fused]), 20))
    del v9_loop, v9_train_it, v9_batch, pipes

    # the training step in banks mode, as the CLI runs it, and the batch
    # pipeline alone, with float32 and int8 banks in turns
    bank_step_ms = {'float32': [], 'int8': []}
    bank_pipe_ms = {'float32': [], 'int8': []}
    bank_loops = {name: TrainLoop(get_model(cfg.replace(bank_dtype=name)),
                                  banks=banks[name]) for name in bank_step_ms}
    for bl in bank_loops.values():
        bl.run_epoch(None, 3, training=True, epoch=99)
    for name in ('float32', 'int8', 'int8', 'float32'):
        bl = bank_loops[name]
        bank_step_ms[name].append(wall_ms(
            lambda: bl.run_epoch(None, 20, training=True, epoch=0), 1) / 20)
        it = iter(DevicePipeline(banks[name], cfg))
        bank_pipe_ms[name].append(wall_ms(lambda: next(it), 20))
    del bank_loops

    # 7, 8. the CLI chain; the banks above are no longer needed
    del banks
    test_src = sources(1, 8, 1875, 128, (40, 130), 0, 1)
    cli = cli_chain(dev, src, test_src, chan4_model)
    del src

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f'all phases: {time.perf_counter() - run_start:.3f} s')
    log('STEP ' + json.dumps({
        'step_ms': step_ms, 'pipeline_ms': pipe_ms, 'model_step_ms': model_ms,
        'empty_launch_ms': empty_ms,
        'banks_step_ms': bank_step_ms, 'banks_pipeline_ms': bank_pipe_ms,
        'batch': cfg.batch_size,
        'n_frame': cfg.n_frame, 'train_loss': logs['loss'],
        'val_loss': logs['val_loss'], 'card': smi}))
    log('SE ' + json.dumps({**{k: v for k, v in se.items()
                                if k != 'se_launches'}, **se_ref,
                             'card': smi}))
    log('MEL ' + json.dumps({**{k: v for k, v in {**mel, **chan}.items()
                                 if not k.endswith('launches')}, **mel_ref,
                              'card': smi}))
    log('EFF ' + json.dumps({
        **{k: v for k, v in eff.items() if k != 'eff_launches'}, **eff_ref,
        **{k: cli[k] for k in ('eff_int8_cli_s', 'eff_eval_s', 'eff_ers')},
        'eff_launches': {**eff['eff_launches'],
                         'cli_int8': cli['eff_int8_launches']},
        'card': smi}))
    density_launches = {
        'synth_mag_f32': density['density_launches']['unfused'],
        'synth_mel_f32': density['density_launches']['fused'],
        'synth_mag_int8': {'synth_mag_int8': sum(
            c.get('synth_mag_int8', 0)
            for c in cli['density_int8_launches'])}}
    log('DENSITY ' + json.dumps({
        **{k: v for k, v in density.items() if k != 'density_launches'},
        **density_ref, 'density_3d_max_abs_err': {
            MEL_KERNELS[dt]: errs[MEL_KERNELS[dt]]['density2048']
            for dt in MEL_KERNELS},
        **{k: cli[k] for k in ('density_cli_s', 'density_cli_batches',
                               'density_7e_s')},
        'density_launches': {**density['density_launches'],
                             'cli_int8': cli['density_int8_launches']},
        'card': smi}))
    log('FUSED ' + json.dumps({**fused_res, 'card': smi}))
    log('BF16 ' + json.dumps({
        **bf16_res, **bf16_ref,
        **{k: cli[k] for k in ('bf16_cli_s', 'bf16_ers', 'loss_optim',
                               'bf16_density_s', 'bf16_7f_s')},
        'cli_launches': {'sj_train': cli['bf16_cli_launches'],
                         'trainer': cli['bf16_density_launches']},
        'card': smi}))
    log('STREAM ' + json.dumps({
        **{k: v for k, v in stream_res.items() if k != 'launches'},
        'resume': {k: v for k, v in resume_res.items() if k != 'launches'},
        **{k: cli[k] for k in ('stream_cli_s', 'sj_train_ckpt_steps',
                               'trainer_ckpt_steps', 'stream_7g_s')},
        'card': smi}))
    log('MESH ' + json.dumps({
        **{k: v for k, v in mesh_res.items()
           if not k.endswith('launches')},
        'launches_a_rank': {dt: mesh_res[f'{dt}_launches']
                            for dt in ('float32', 'int8')},
        'times': 'two ranks on one card, not a speed measurement',
        'card': smi}))
    log('MESH_GRAPH ' + json.dumps({**mesh_graph_res, 'card': smi}))
    log('ITER ' + json.dumps({**iter_res, 'card': smi}))
    keras = cli['keras']
    log('KERAS ' + json.dumps({**{k: v for k, v in keras.items()
                                  if k != 'keras_launches'}, 'card': smi}))
    log('CLI ' + json.dumps({k: v for k, v in cli.items()
                             if not k.endswith(('launches', 'ckpt_steps'))
                             and not k.startswith(('density', 'bf16_',
                                                   'loss_optim',
                                                   'stream_', 'keras'))}))
    log(smi)
    runs = {'synth_mag_f32': (launches, TRAIN_STEPS + VAL_STEPS),
            'synth_mag_bf16': (cli['bf16_launches'], cli['bf16_batches']),
            'synth_mag_int8': (cli['int8_launches'], cli['int8_batches']),
            'synth_flat_f32': (chan['chan_launches'][4], 2),
            'synth_flat_bf16': (chan['chan_launches'][3], 2),
            'synth_flat_int8': (cli['chan3_launches'],
                                cli['chan3_cli_batches']),
            'synth_se_f32': (se['se_launches'], se['se_batches']),
            'synth_se_bf16': (cli['se_bf16_launches'], cli['se_cli_batches']),
            'synth_se_int8': (cli['se_int8_launches'], cli['se_cli_batches']),
            **{k: (mel['mel_launches'][run], n) for k, run, n in (
                ('synth_mel_f32', 'v9_float32', TRAIN_STEPS + VAL_STEPS),
                ('synth_mel_bf16', 'v9_bfloat16', 2),
                ('synth_mel_int8', 'v9_int8', 2))}}
    # the launches of phases 5h and 7f, the bfloat16 models' runs
    bf16_launches = [bf16_res[k]['launches'] for k in
                     ('vad_v8', 'eff_b0_v1', 'se_v9')] + [
        bf16_res['density_launches'], cli['bf16_cli_launches'],
        cli['bf16_density_launches']] + [
        r['launches'] for r in cli['loss_optim'].values()]
    # the launches of phases 5i, 5j and 7g, on chunk banks and resumed
    stream_launches = ([stream_res['launches']] + resume_res['launches']
                       + cli['stream_cli_launches'])
    log(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': 'challenge_tpu_torch/csrc/' + (
            'synth_mel.cu' if name.startswith('synth_mel') else 'synth.cu'),
        'replaces': 'challenge_tpu/ops/pallas_synth.py:79',
        'launches': runs[name][0].get(name, 0),
        'launches_per_step': runs[name][0].get(name, 0) / runs[name][1],
        'density_launches': density_launches.get(name, {}).get(name, 0),
        'bf16_launches': sum(c.get(name, 0) for c in bf16_launches),
        'stream_launches': sum(c.get(name, 0) for c in stream_launches),
        'keras_7h_launches': keras.get('keras_launches', {}).get(name, 0),
        'mesh_5k_launches': sum(c.get(name, 0) for dt in ('float32', 'int8')
                                for c in mesh_res[f'{dt}_launches']),
        'mesh_5m_launches': mesh_graph_res['launches'].get(name, 0),
        'iter_5l_launches': (iter_res['launches'] if name == f32_kernel
                             else 0)
        + iter_res['sample_batch']['launches'].get(name, 0),
        'max_abs_err': max(errs[name].values()),
        **timing[name], 'library_ms': None} for name in runs]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
