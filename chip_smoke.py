"""Drive the PyTorch port's sampling, serving, training and evaluation
paths once on one CUDA GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (the kernels are built with nvcc for sm_90a on
first use) and exits non-zero without one. Phases, each fatal on failure:

  setup  card name, count and power limit; build the CUDA kernels; TF32 off
         for matmuls and cuDNN.
  A      each hand-written kernel against its plain PyTorch version on the
         card, at the flagship shapes the main path gives it (B = 32 rows of
         the CFG-doubled micro-batch of 16, T = 196 and 98, ragged mask):
         favor_qkv and performer_epilogue in bf16 and f32; the bf16
         silu, gelu (with a Dense bias) and sigmoid kernels, which round
         where the JAX package rounds, and their gradient pass (JAX's bf16
         gradient steps, the backward in training), against their plain
         versions' bits;
         max errors against the stated tolerances; kernel and plain times
         per call (CUDA events over back-to-back calls) and device times
         (torch.profiler). favor_qkv (the tensor cores, 3xTF32, rows split
         over a thread-block cluster) also: the same bits on a second
         call, its bound at three TF32 passes beside the IEEE-FMA floor of
         PRs 1-5's design, its time at 1, 2, 4 and 8 CTAs per (b, h) at
         B*H = 128 and at a serving batch of B*H = 8, and under
         FAVOR_MXU_BF16=1 against the plain version with bf16 operands.
         favor_qkv also in its two seq launches (favor_qkv_moments and
         favor_qkv_apply) at T = 196 cut as 98 / 98 and 50 / 50 / 48 / 48
         (ExpertMesh.frames), bf16 and f32: each cut's moments summed on
         the card, each cut's apply, concatenated, against the whole kernel
         and against the plain split; both launches timed in bf16 at a seq
         4 rank's 50 frames beside their bounds; kernel 8's two launches
         likewise against favor_attention (f32).
         performer_epilogue (kernel 2) is fed scale and shift as the style
         block feeds them, strided views of one [B, 2D] tensor; it also
         prints the same bits on a second call, its time per call under
         inference mode (the sampling path's launch) beside the time with
         grad, the unfused chain of PyTorch calls (F.layer_norm, L2,
         F.layer_norm, modulation, F.silu in f32) timed in turns with it,
         its time at 1-16 blocks per batch row and the number the wrapper
         takes on this card, the host's microseconds per call of its
         launch path part by part, and ptxas's registers and spills of its
         kernels (none may spill at D = 512).
  B      the full-width flagship denoiser (ExperimentConfig.moe_small(),
         seeded init, zero-init leaves perturbed) forward once through the
         kernels and once with use_kernels=False, in f32 compute (tight
         tolerance) and in the flagship's bf16 compute (each path's distance
         from the f32 result: the kernels' may be no larger than 1.5x the
         plain bf16 path's, plus a small floor). Then 3 DPM-Solver++ steps
         for 2 prompts in f32 compute, through the kernels and without.
  C      GenerationPipeline(dpm, 20 steps, micro_batch 16, bf16 weights)
         behind make_server: /healthz, concurrent seedless requests merged by
         the batcher, mixed lengths, a seeded request twice (identical);
         finite motions of the right shapes, finite recover_from_ric; both
         kernels launched exactly 32 x (forwards) times and the three
         activation kernels their exact counts per forward; the CUDA kernels
         and device time of one forward. Then one ddim50 and one dpm20
         generate of 16 prompts at 196 frames, timed.
  D      training. D1: the two backward kernels against their plain versions
         at the training shapes (B = 32, T = 196 and 98, H = 4, D = m = 128,
         ragged mask; favor_qkv_bwd in bf16 and f32, with and without
         d(proj); performer_epilogue_bwd in bf16 at width 512), max errors
         against stated tolerances, kernel and plain times; favor_qkv_bwd
         as favor_qkv in A (repeated bits, the 3xTF32 bound and the
         IEEE-FMA floor, the cluster sweep); performer_epilogue_bwd also
         with the same bits on a second call, its blocks per batch row
         (the thread-block cluster), the device time of each of its two
         launches, and ptxas's registers and spills of its main kernel
         (none may spill at D = 512). favor_qkv_bwd also in its three seq
         launches (favor_qkv_bwd_kv, _q, _k) at T = 196 cut as 98 / 98 and
         50 / 50 / 48 / 48, bf16 and f32: kv and g_kv summed on the card
         between them, against the whole kernel and the plain split; each
         launch timed in bf16 at a seq 4 rank's 50 frames beside its
         bound. D2: one
         full-width train step in f32 compute (dropout 0, no stochastic
         depth) through the kernels and with use_kernels=False on the same
         batch, noise and t: equal losses, a finite gradient for every
         trainable parameter, per-parameter gradient rel RMS within a stated
         tolerance. D3: tools/train.py main() on the synthetic dataset at the
         flagship defaults (dropout 0.1, the uncond double step), 64 samples
         at batch 32 = 4 optimizer steps: finite losses, a checkpoint, a
         second main() that resumes at step 4, epoch 1; favor_qkv and its
         backward launched 32 x forwards and 32 x backwards, the epilogue
         and its backward never (dropout takes the unfused path), the
         activations' gradient pass at least once per step; ms per
         optimizer step. D4: two steps through Trainer at dropout 0, where
         the epilogue and its backward run 32 times per step each.
  E      this slice's two switches, ModelConfig.use_fast_xattn and
         MOE_FUSED_KERNEL=1. E1: the fused-MoE and fast cross-attention
         kernels against their plain versions on the card, in bf16 and f32
         (MoE at the flagship shape, at S = 600, at E = 3 experts and at
         the moe_big shape, each with the same bits on a second call and
         the SHA-256 of its output;
         cross-attention at the flagship shape and at H = 8, D = 96), with
         kernel, plain and device times, the bound, scaled_dot_product_attention
         as the cross-attention's library yardstick, the MoE kernel's times
         also at the moe_big shape, at a quarter of the flagship's tokens
         and beside the unfused path's cuBLAS chain at the flagship shape
         (its yardstick: several calls, not one, so its library_ms stays
         null), and each gradient
         through its autograd Function against autograd of the plain
         version. The bf16 cross-attention (the tensor-core kernel, also at
         N = 1024 keys) is held to at most 1% of its values one ulp from
         the plain version; E1 prints that share, SDPA's, and the floor of
         IEEE f32 FMA products beside the bound. E2: the full flagship denoiser with both switches on vs
         both off and use_kernels=False, in f32 (tight) and in bf16 (each
         against the f32 result, phase B's rule). E3: a dpm20 request of 16
         prompts x 196 frames through make_server with both switches on:
         favor_qkv, performer_epilogue and moe_dense_fused launched exactly
         32 and xattn_fastlayout 16 times per forward, the activation
         kernels their exact counts; device kernels per
         forward and s/motion with the switches off and on, in turns. E4:
         two Trainer steps at dropout 0 with use_fast_xattn (16
         xattn_fastlayout launches per forward, none of moe_dense_fused in
         training), every trainable parameter with a finite gradient.
  F      the module attributes that no config sets, and the last four
         kernels. F1: adaln_dense, favor_attention, flash_cross_attention
         and favor_attention_full against their plain versions at the
         flagship shapes, in f32 and (all but favor_attention, which takes
         f32) bf16; flash_cross_attention also at N = 1024 keys and at a T
         that is no multiple of its 32-row tile; adaln_dense also at
         B*T = 305 rows (no multiple of its 96-row tile) with Dout = 320,
         with the same bits on a second call, and in bf16 timed beside the
         unfused StylizationBlock chain (LayerNorm, modulation, SiLU, the
         cuBLAS Dense with its bias: several calls, so its library_ms
         stays null); favor_attention_full bit
         for bit against favor_qkv on the merged panel; in bf16
         flash_cross_attention (the tensor-core kernel) is held to the
         share-and-ulp rule of E1; kernel, plain and
         device times, the bound, scaled_dot_product_attention as the
         flash kernel's library yardstick, and each gradient through its
         autograd Function. F2: at the flagship width in f32,
         StylizationBlock(fused=True) against fused=False,
         PerformerSelfAttention(fused=False), grafted from a fused one by
         models/bridge.py, against it, FastAttention use_pallas on against
         off, and one backward through the unfused Performer. F3: the
         flagship denoiser with every style block fused and every Performer
         unfused (the same weights), one forward at B = 32: adaln_dense,
         favor_attention and performer_epilogue launched exactly 32 times,
         favor_qkv never; against the standard flagship and against itself
         with use_pallas=False and use_kernels=False in f32; in bf16 compute
         both paths against the f32 result (phase B's rule); CUDA kernels
         and device time per forward against the standard flagship, in f32
         and in bf16 compute.
  G      serving an export, and the widths of tools/train.py --model_size
         big. G1: the flagship written by tools/export.py's export_model
         in bf16 (the JAX package's flax-msgpack format), served by
         tools/serve.py's build_server (dpm20, micro_batch 16, on the card
         by default): /healthz, concurrent seedless requests merged, a
         seeded request twice (identical) and bit for bit against
         GenerationPipeline(model, param_dtype="bfloat16") from the
         in-memory model; favor_qkv and performer_epilogue launched
         exactly 32 x forwards; the export's write and read rates (host)
         and the latency p50 / p99 of 8 sequential single-prompt requests
         at 196 frames. G2: --model_size big (latent 1024, head dim 256,
         expert hidden 512, 2 blocks per scale), the widths of the kernel
         instances added for it: G2a kernels 1-5 and 7 against their plain
         versions at the shapes that path gives them, bf16 and f32, with
         times, bounds and ptxas's registers and spills at those widths;
         G2b one forward at B = 4 through the kernels (MOE_FUSED_KERNEL=1)
         against use_kernels=False, f32 tight and bf16 by phase B's rule,
         with exact launch counts of kernels 1, 2 and 5; G2c two optimizer
         steps through the train CLI, launching kernels 1 and 3. Since PR
         12 G2a also holds kernels 6 and 9 at head dim 256 (bf16 by E1's
         rule, f32 tight) with times, the bound and SDPA's time, and fails
         on a spill of the bf16 instance; G2b runs the forward again with
         use_fast_xattn, kernel 6 launched once per cross-attention block.
  H      training from raw joints. H1: 48 synthetic t2m clips (60-240
         frames, the port's Skeleton over a root that walks and stands)
         through tools/prepare_data.py on the card and on the CPU: every
         clip kept, 263 finite features, Mean / Std / meta/ written, card
         and CPU features within 1e-4, foot contacts equal, clips/s; 40
         KIT clips the same way. H2: texts and train.txt for the corpus
         (whole-clip and sub-clip lines), Text2MotionDataset with the
         native store: uncropped batches equal the Python path's, every
         crop a window, host ms per batch of 32 native vs Python. H3:
         tools/train.py main() on the corpus at the flagship defaults but
         1 block a scale (full width, bf16, dropout 0.1; H_LAYERS, which
         pays for phases M and O), 4 optimizer steps: finite losses,
         kernels 1 and 3 launched 4 x 4 times each, meta/ the dataset's
         normalizer, ms/step beside D3's; then 2 steps with
         --no_native_io and 2 on the KIT corpus.
  I      evaluating H3's trained t2m run (kept with H's corpus until I is
         done) on a test split over the corpus's ids, with a finest.tar of
         the released shapes and seeded weights and the committed GloVe
         fixture. I1: tools/evaluate.main on the card, dpm20, the host
         path, 1 replication, the protocol cut to the split (pools of 32,
         diversity 30, mm 4 x 6, mm times 3, micro-batch 16, joint scores
         over 32 samples; each cut printed): every summary metric finite,
         the log holding each metric's summary, kernels 1 and 2 launched
         exactly (Performers per forward: 4 at H3's 1 block a scale) x
         21 x micro-batches; seconds per replication, s/motion,
         evaluator ms per pool of 32, bytes fetched. I2: the same with
         --device_embeddings, 1 replication: replication 0's Matching
         Score, R-precision and FID within 1e-4 relative of I1's (the same
         motions embedded), the bytes fetched. I3: the evaluator on the
         card (f32, TF32 off) against the same weights on the CPU, one
         pool's co-embeddings within 1e-4 of their largest value, ms per
         pool on each, and the difference cuDNN's default TF32 makes. I4:
         ddpm_sample_loop, ddim_sample_loop(cond_fn=...) and calc_bpd_loop
         through the run's conditional branch at B = 4 on a 50-step
         respaced schedule: finite, kernels 1 and 2 launched 50 x
         (Performers per forward) times per loop.
  J      the DeBERTa-v3-large text encoder (434 M parameters, f32 compute
         whatever the denoiser's dtype) in front of the flagship denoiser,
         ExperimentConfig.moe_small() with text_encoder="deberta-v3-large".
         DeBERTa has no Pallas kernel in the JAX package and none here; the
         denoiser behind it launches kernels 1-4. The denoiser runs at 1
         block a scale (full width; J_LAYERS), which pays for phases M and
         O, so the launch counts below are 4 a forward. J1: the flagship
         built and
         seeded (the seconds of init_weights printed); the encoder on the
         card against the same module on the CPU over 4 ragged prompts (one
         empty, the CFG branch), pooled and tokens within DEBERTA_REL of
         their largest value; ms per encode of 32 prompts (CUDA events),
         its device time in all and by kernel, and its f32 bound (TF32
         off). J2: GenerationPipeline(dpm, 20 steps, micro_batch 16, bf16
         weights); its model (the MoE FFN behind DeBERTa, bf16 compute)
         through the kernels and with use_kernels=False, both held to the
         same weights in f32 compute by phase B's rule, with the top-2
         routings the two paths chose differently printed; then behind
         make_server: 16 prompts at mixed lengths, finite motions of the
         right shapes, favor_qkv and performer_epilogue launched exactly 8 x
         forwards, the text encoder run on the card twice per micro-batch
         (its prompts and its empty prompts) and never per denoising step,
         counted by a forward hook; s/motion beside phase
         C's dpm20. J3: tools/train.py --text_encoder deberta-v3-large
         --deberta_ckpt DIR --ema_decay 0.9999 on the synthetic dataset,
         2 optimizer steps at B = 32, DIR holding a seeded HF-layout
         pytorch_model.bin in half precision that J3 writes: the grafted
         backbone and its EMA equal the file's tensors (cast to f32) bit
         for bit at step 0, finite losses, every layer's weights moved by
         the steps, favor_qkv and favor_qkv_bwd launched 8 x 2 and the
         epilogue and its backward never (dropout 0.1); ms/step beside
         D3's.

  K      the single-device rest of the JAX package at the flagship's full
         width and depth (ExperimentConfig.moe_small(), seeded weights,
         zero-init leaves perturbed, bf16 compute). K1: moe_compute "dense"
         and "dispatch" through the kernels against use_kernels=False (f32
         tight, bf16 by phase B's rule, at B = 32), dense against
         dense_fused (f32 tight, bf16 by phase B's rule), dispatch at
         capacity factor E (no slot dropped) against dense (f32 tight, bf16
         by phase B's rule), the slots dispatch drops at the default factor
         2; then dpm20 of 16 prompts x 196 frames (CFG micro-batch 16, bf16
         weights) through a pipeline built in each mode (every MoE layer of
         its model checked to compute in that mode), kernels 1 and 2
         launched exactly 32 x 21 times, s/motion and peak memory. K2: one
         train step after a warm-up step at B = 32, dropout 0.1, in each
         mode: finite loss and grad norm, kernels 1 and 3 launched 32 times
         a step, ms/step and peak memory. K3: a run dir of the flagship
         written through CheckpointManager (with a seeded normalizer),
         tools/visualize.py --sampler dpm --motion_length 120 on it: a GIF
         of 120 frames at 20 fps, joints [120, 22, 3] finite and bit for
         bit those of an in-process pipeline on the in-memory weights ->
         recover_from_ric -> motion_temporal_filter from the same seed,
         kernels 1 and 2 launched 32 x forwards. K4:
         tools/serving_quality.py --batch 8 with a seeded finest.tar on a
         run dir of the flagship at K4_LAYERS (1) block a scale (full
         width; the reference's 1,153 forwards are host-bound): a finite
         table, the two bf16 drift lines, kernels 1 and 2 launched 4 x 1153
         forwards, seconds. K5:
         tools/profile_bench.py --mode sample --steps 5 --batch 16 and
         --mode train --batch 8: the family table's total within 10 % of
         the profiler's device total, the rows of kernels 1 and 2 (train:
         1 and 3) present, each family's share printed.
  L      a JAX run's orbax checkpoint. L1: the committed fixture
         tests/fixtures/jax_orbax_run/ (written by the JAX package's
         CheckpointManager: OCDBT, zstd chunks, bf16 mu) read with this
         machine's libzstd (its path and version printed): every leaf, the
         step and the epoch equal its .npz bit for bit, and
         CheckpointManager.read and load_run equal the bridge of those
         leaves; its width has no kernel instance, so no kernel runs. L2:
         the flagship at L_LAYERS (1) block a scale (full width, bf16
         compute, EMA 0.999, warmup 100) trained 2 steps
         at B = 32, dropout 0.1, saved in the JAX layout (plain zarr; the
         bytes, seconds and GB/s of the write and of the read, the file
         layer apart from the tree's conversion); Trainer.fit resumes the
         step for 2 more steps, and the read of its restore gives params,
         mu, nu, count, EMA, step, epoch and the generator back bit for
         bit; load_run(use_ema=True) -> dpm20 of 16 prompts x 196 frames
         bit for bit against the in-memory EMA, kernels 1 and 2 launched
         exactly 8 x 21 times, s/motion; the resumed steps against the
         in-memory state continued with the same generator (bit for bit,
         or within phase B's floor: which one is printed), kernel 3
         launched 8 x 2 times, and the end-of-epoch save asked of the
         JAX-format manager (recorded, not written again: the first save
         wrote that layout).
  M      data-parallel training and ZeRO-1 over torch.distributed
         (parallel/): the flagship at full width and M_LAYERS (1) block
         a scale, f32 compute,
         dropout 0, EMA 0.999, one global batch of 32 at T = 196 with
         ragged lengths (long on rank 0's rows, short on rank 1's), t and
         noise injected. M1 (i): one rank over NCCL through parallel/
         against the plain one-process TrainStep on the same batch: loss,
         grad_norm, parameters, mu, nu and EMA bit for bit (zero1 off);
         with zero1 (reduce_scatter_tensor / all_gather_into_tensor) within
         the stated tolerances. M1 (ii): two ranks on this one card, gloo
         named (NCCL refuses two ranks on one device), CUDA tensors staged
         through the host, zero1 off and on, each against the one-process
         step that rank 0 runs (tests/test_torch_parallel.py's
         tolerances); per rank: the launches of kernels 1-4 in the step
         (4 each at M_LAYERS), the resident elements and bytes of the moments and the
         EMA (under zero1 one shard of each, at most ceil(n / W) plus the
         256-byte alignment of each tensor in the flat buffers),
         max_memory_allocated of the step and ms per step (two ranks
         sharing one card: not a speed-up); then 2 steps in the flagship's
         bf16 compute with zero1, finite, the same launches. (M2, the
         train CLI as two processes, is subsumed by N3 in the whole run;
         scripts/dp_cards.py still runs it on N cards.)
  N      expert-parallel MoE training (parallel/mesh.py,
         parallel/moe_parallel.py): ExperimentConfig.moe_big() (latent
         768, 8 heads of 96, 16 experts of hidden 1024, top-2) at 1 block
         a scale (N_LAYERS; full width; 214.7 M parameters), seeded, on 8
         ranks sharing this card over gloo, each a --n-rank worker, the
         CUDA tensors of every collective staged through the host. N1:
         the MoE layer at moe_big's widths (4 rows x 196 frames a rank,
         cf 2.0), dispatch (the all-to-all, each rank's chunk its
         capacity) and dense (all-gather, reduce-scatter of the f32
         partial sums), f32 and bf16, against the one-process layer that
         rank 0 runs chunk by chunk (capacity_dispatch_ffn routed as the
         expert-parallel dispatch routes, or dense): the output and the
         gradients of x, the gate and the experts within a rel RMS of
         N_LAYER_F32_REL / N_LAYER_BF16_REL, the dropped pairs equal. N2:
         one train step through the Trainer on the global batch of 32
         (M1's batch: ragged lengths, injected t and noise, dropout 0,
         EMA 0.999, f32) in four layouts: moe_big as written (ep = 8, its
         dense_fused run as dense), ep = 8 with dispatch, ep = 4 x dp = 2
         with ZeRO-1 and dispatch, ep = 1 x dp = 8 with ZeRO-1 and
         dispatch (the global batch's capacity); rank 0 first runs the
         one-process steps (dense; dispatch with chunked_dispatch, the
         per-chunk capacity; dispatch on the global batch) and keeps
         them in its host memory. Each layout against its reference by
         M1's rules (loss and grad_norm, the gradients caught where the
         optimizer clips them, the parameters after the update), the
         gathered EMA and mu against what the gathered parameters and
         gradients make of them; per rank: kernels 1-4 launched 8 times a
         step, 1 / ep of the expert elements held, max_memory_allocated,
         ms a step (eight ranks on one card, collectives through the
         host: not a speed). N3: tools/train.py --num_processes 8
         --expert_parallel 8 --data_parallel 1 --zero1 at moe_big's widths
         and 1 block a scale as 8 processes on this card (--m2-rank), 2
         optimizer steps and the save: only rank 0 logs and writes, the
         checkpoint holds the global [16, ...] experts; then a one-process
         resume of the run dir starts at step 2 with the gathered state
         bit for bit.
  P      tensor-parallel and seq-parallel training (the model axis's
         Megatron split: parallel/mesh.py, parallel/moe_parallel.py's
         column inputs and row-parallel sums, training/train_state.py's
         gradient groups; the seq axis: each rank its frames, kernels 1
         and 3 in their split launches around the kv and g_kv sums):
         the flagship at full width (latent 512, 4 heads of 128, 4 experts
         of hidden 256, the cross-attention MLP 2048) at 1 block a scale
         (P_LAYERS), seeded, on P_W (4) ranks sharing this card over gloo,
         each a --p-rank worker, the model and seq ranks of a row-holder on
         the same rows of M1's batch. P1: one train step through the
         Trainer in three layouts, seq 2 x model 2 and seq 4 (cut 50 / 50 /
         48 / 48) computing dense, and expert 2 x model 2 computing
         dispatch with ZeRO-1 (the seq ranks launch favor_qkv_moments /
         _apply and favor_qkv_bwd_kv / _q / _k once a Performer each, and
         never the whole favor_qkv or favor_qkv_bwd), and data 2 x pipe 2
         (parallel/pipeline_parallel.py's GPipe ring) at P3_LAYERS (2)
         blocks a scale, one a stage, P3_M (4) microbatches, dense_fused
         (each stage launches kernels 1-4 for its own block once a
         microbatch, 16 each a step; its loss within P3_LOSS_REL of the one
         process; the replicated leaves' SHA-256 the same on the four
         ranks; each rank's block bytes half of all blocks'; the stage
         memory report beside max_memory_allocated); rank 0 first runs the
         one-process steps (dense; dispatch with chunked_dispatch(2), the
         per-chunk capacity of the two row-holders; p3_reference, the
         balance term over the ring's chunks). Each layout: the loss
         and grad_norm within STEP_LOSS_REL of the one-process step's, the
         gradients (caught where the optimizer clips them, gathered) by
         N2's rule and by the tests' (each within 1e-4 of its leaf's
         largest entry plus 1e-7), and the one-process optimizer applied
         to that gradient giving the gathered parameters and EMA within
         P_STEP_ABS and mu within P_MU_REL of its largest entry (the
         update rule of tests/test_torch_moe_parallel.py); per rank:
         kernels 1-4 launched 4 times a step, 1 / tp of every leaf JAX's
         rule cuts (and 1 / ep of the experts), its row-holder index,
         max_memory_allocated, ms a step (not a speed). P2:
         tools/train.py --num_processes 4 --tensor_parallel 2 --zero1 at
         the flagship's widths and 1 block a scale as 4 processes
         (--m2-rank), 2 optimizer steps and the save: only rank 0 logs and
         writes, the checkpoint holds the global layout and one generator
         state a row-holder; then a one-process resume of the run dir
         starts at step 2 with the gathered state bit for bit.
  O      sampling, serving and evaluation over ranks (GenerationPipeline
         with a (data, expert, model) mesh, parallel/mesh.py::
         generation_mesh), ranks sharing this card over gloo, the CUDA
         tensors of every collective staged through the host; on each rank
         kernels 1 and 2 counted from just before its main path to just
         after, max_memory_allocated, the parameter bytes it holds, its
         expert elements (1 / ep) and split FFN elements (1 / tp), and a
         SHA-256 of its motions (every rank returns the same). O1: the
         flagship at full width and depth, f32 compute, bf16 weights, dpm2
         (O1_STEPS) of 16 prompts x 196 frames (micro-batch 16) on O_W (4)
         --o1-rank ranks in five layouts (data 2 x seq 2; expert 2 x model
         2; dispatch at data 2 x expert 2, capacity factor 4, which drops
         nothing; seq 4, T cut 50 / 50 / 48 / 48; data 2 x pipe 2, 4 blocks
         a stage, 4 microbatches), each within O1_REL of the one-process
         pipeline of the function it computes (dense_fused at data, seq and
         pipe ranks alone, else dense); a seq rank launches kernel 1's
         moments and apply once a Performer each and the whole kernel 1
         never; a pipe rank its own blocks' kernels once a microbatch, and
         holds half the expert and split elements. O2: tools/serve.py as 4 processes (--o2-rank;
         --data_parallel 2 --tensor_parallel 2) from the flagship's bf16
         export at micro-batch 4, dpm2, 3 seeded requests (1, 3 and 6
         prompts: the last two micro-batches) each within O2_REL of the
         one-process server's answer (bf16 compute), then SIGTERM to rank
         0: every rank exits 0. O3: moe_big at full width, O3_LAYERS (1) of
         its 12 blocks a scale (16 experts over its 8 expert partitions) on 8
         --o3-rank ranks, each seeding its shard leaf by leaf on the card
         (seeded_state), bf16 weights, f32 compute (o3_config says why),
         dense, one micro-batch of 2 prompts, dpm with O3_STEPS (3) steps,
         within O3_REL + O3_FLOOR x (the one process's dense_fused against
         its dense) of the one-process moe_big of the same weights. O4 (run
         after phase I, on its run): tools/evaluate.py --data_parallel 2 as
         two --o4-rank processes (--device_embeddings taking the host path,
         with the warning), a 16-item split, 1 replication, every metric
         within O4_REL of the one-process run's.

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; the line before it lists the kernels of the paths, each with
its launches on its path, its error against its plain version, its time,
the plain version's, the least time the card could take (bound) and,
where one PyTorch call computes the same function, that call's time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 0
# bf16 kernel outputs are the f32 result rounded once: one bf16 ulp
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-3
F32_REL = 1e-4          # same f32 math, another summation order
# whole denoiser, kernels vs use_kernels=False. In f32 compute: the same
# math in another order. In bf16 compute the two paths round at different
# places (the plain path rounds to bf16 between the epilogue's steps), and
# near-tied MoE router probabilities then pick another expert for some
# tokens (top-2 is discontinuous), so both are held to the f32 result
# instead: the kernel path may be at most 1.5x as far from it as the plain
# bf16 path is, plus a floor for when the plain path happens to land close
DENOISER_F32_REL_RMS = 1e-4
DENOISER_BF16_FACTOR, DENOISER_BF16_FLOOR = 1.5, 5e-3
# 3 sampler steps in f32: the denoiser's ~1e-6 carried through guidance 7.5
# and the eps -> x0 factor sqrt(1/abar - 1) (~1.6e2 at t = 999)
SAMPLE_F32_REL = 1e-4
# backward kernels vs their plain versions: f32 outputs are sums over T (and
# over B*H for the shared parameters) in another order -> 1e-3 of the
# output's largest value; bf16 gradients are that result rounded once ->
# one bf16 ulp plus the same floor
BWD_FLOOR = 1e-3
# one f32 train step, kernels vs use_kernels=False: the loss is the same
# math in another order; each parameter's gradient RMS error relative to
# its own RMS, floored at 1e-3 of the RMS of all gradients (some gradients,
# e.g. the key biases of a softmax over keys, are zero up to rounding)
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL_RMS = 1e-3
# fused MoE in bf16 vs its plain version: the final rounding (one ulp) plus
# the rare one-ulp flips of a rounded hidden activation, each worth one ulp
# of one term of the second product -> 2^-7 |plain| + 1e-3 max|plain|
MOE_BF16_FLOOR = 1e-3
# the fused ops' gradients on the card: autograd of the plain version in
# both cases, the same computation -> 1e-5 of the largest gradient
GRAD_REL = 1e-5
# the exact cross-attention in bf16 (kernels 6 and 9 on the tensor cores,
# the probabilities in two bf16 terms): at most this share of the outputs
# one ulp from the plain version's (f32 throughout, one rounding), none
# further; the ulp floored at 2^-16 of the largest value, the f32 sums'
# absolute error where values cancel to near zero
XATTN_FLIP_SHARE = 0.01
# the bf16 activations take the plain versions' steps: their bits on all but
# this share of the values (expf / tanhf against PyTorch's in the last f32
# bit), one ulp elsewhere
ACT_FLIP_SHARE = 1e-3
# phase F, f32: a module form against the one it replaces (the same math,
# another order of the f32 sums) and the flagship with every style block
# fused and every Performer unfused against itself on the plain paths
MODULE_F32_REL_RMS = 1e-5
FORMS_F32_REL_RMS = 1e-5
# phase J: DeBERTa on the card against the same module on the CPU, f32
# throughout (cuBLAS with TF32 off): 24 layers of the same products in
# another summation order -> 1e-4 of the output's largest value
DEBERTA_REL = 1e-4
# the least time the card could take: published H100 SXM peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def bound(nbytes: float, flops: float, kind: str):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move over the memory rate and its operations over the peak rate
    of their type (``PEAK_FLOPS``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(heads: int, T: int, N: int, D: int):
    """Exact bf16 attention of ``heads`` heads, T queries over N keys of
    width D: (bound ms, its "by", the f32-FMA floor ms). q, k, v are read
    and the output written once in bf16; the two products run at the bf16
    tensor-core rate, which is what the card offers for bf16 operands (q . k
    of bf16 values is exact in f32 accumulation). A design that holds both
    products in IEEE f32 FMAs, as PR 4's kernels did, cannot go below the
    same operations at the f32 rate: that floor is printed beside the bound,
    never in its place."""
    nbytes = 2 * heads * (2 * T * D + 2 * N * D)
    flops = 4 * heads * T * N * D
    b_ms, b_by = bound(nbytes, flops, "bf16")
    return b_ms, b_by, flops / PEAK_FLOPS["f32"] * 1e3


def favor_bound(nbytes: float, flops: float):
    """The FAVOR+ kernels (1, 3, 8, 10), whose products must keep f32
    accuracy in front of the exp: (bound ms, its "by", the IEEE design's
    floor ms). On Hopper's tensor cores that takes three TF32 passes
    (3xTF32, the kernels' own design), so the bound is 3 x ``flops`` at the
    dense TF32 rate, or the bytes where they take longer. A design that
    holds the products in IEEE f32 FMAs, as PRs 1-4's did, cannot go below
    ``flops`` at the f32 rate: that floor is printed beside the bound,
    never in its place."""
    b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
    return b_ms, b_by, flops / PEAK_FLOPS["f32"] * 1e3


def cluster_s(bh: int, dev, per_sm: int) -> str:
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    return (f"{P.favor_cluster(bh, dev, per_sm)} CTAs per (b, h) in a "
            f"cluster")


def cluster_sweep(tag, name, kernel, small, per_sm):
    """Times of a FAVOR+ kernel with the CTAs of a thread-block cluster
    forced to 1, 2, 4 and 8 per (b, h): ``kernel`` at the flagship batch
    (B*H = 128) and ``small`` at a serving batch of one CFG-doubled prompt
    (B*H = 8), against the wrapper's own choice (``favor_cluster``)."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    dev = torch.device("cuda", 0)
    auto = P.favor_cluster
    picks = (auto(128, dev, per_sm), auto(8, dev, per_sm))
    times = {}
    try:
        for c in (1, 2, 4, 8):
            P.favor_cluster = lambda bh, d, per_sm, c=c: c
            times[c] = (time_ms(kernel, 10), time_ms(small, 10))
    finally:
        P.favor_cluster = auto
    print(f"[{tag}] {name} by CTAs per (b, h), ms per call (CUDA events): "
          + ", ".join(f"{c}: {a:.4f} (B*H=128) / {b:.4f} (B*H=8)"
                      for c, (a, b) in times.items())
          + f"; the wrapper picks {picks[0]} and {picks[1]}")


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int = 20):
    """(kernel ms, plain ms) timed in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(plain_fn, iters), time_ms(kernel_fn, iters),
                      time_ms(kernel_fn, iters), time_ms(plain_fn, iters))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _profiled_kernels(fn, iters: int):
    """{CUDA kernel name: its device time in us over ``iters`` calls of
    ``fn``} from one accepted torch.profiler session, or None.

    The profiler loses the first kernels of a session now and then, or
    all of them (seen on an H100 under torch 2.11 for calls that it had
    timed earlier in the same process). So each session traces a warm-up
    cycle of ``iters`` calls that it discards before the cycle it keeps;
    and, as every call launches the same kernels, a session counts only if
    its kernel count is a positive multiple of ``iters``. It is asked up
    to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the kept one
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n and n % iters == 0:
            return {e.key: e.self_device_time_total for e in events}
    return None


NOT_PROFILED = ("not measured (torch.profiler recorded no whole set of CUDA "
                "kernels)")


def device_ms(fn, iters: int = 20) -> str:
    """Device time of one call: the sum of the CUDA kernels' own times
    that torch.profiler records over ``iters`` calls, divided by
    ``iters``. Unlike back-to-back CUDA events it leaves out the host's
    launch cost, which exceeds a short kernel's run time. If no profiler
    session counts (``_profiled_kernels``), the result is "not measured",
    and the CUDA-event times printed beside it are the only ones for that
    call. This number is printed and nothing else: no check and no line
    of JSON reads it."""
    times = _profiled_kernels(fn, iters)
    if times is None:
        return NOT_PROFILED
    return f"{sum(times.values()) / iters / 1e3:.4f} ms"


def device_ms_by_kernel(fn, iters: int = 20) -> str:
    """``device_ms`` split by CUDA kernel: each kernel's device time per
    call, under its short name, the longest first."""
    times = _profiled_kernels(fn, iters)
    if times is None:
        return NOT_PROFILED
    short = {}
    for key, us in times.items():
        name = re.sub(r"<.*|\(.*", "", key.replace(
            "(anonymous namespace)::", "")).split("::")[-1].split()[-1]
        short[name] = short.get(name, 0.0) + us
    return ", ".join(f"{name} {us / iters / 1e3:.4f} ms" for name, us in
                     sorted(short.items(), key=lambda kv: -kv[1]))


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes: equal
    digests, equal bits."""
    import torch

    raw = t.detach().contiguous().cpu().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def ragged_mask(rng, B, T, dev):
    import torch

    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return torch.from_numpy((np.arange(T)[None] < lengths[:, None])
                            .astype(np.float32)).to(dev)


def unfused_epilogue_chain(y, scale, shift, ps, pb, ss, sb):
    """Kernel 2's function as a chain of PyTorch calls in f32: F.layer_norm,
    the L2 scaling, F.layer_norm, the modulation, F.silu, one rounding to
    y's dtype. A function of no arguments for timing."""
    import torch
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops.performer import LN_EPS

    D = y.shape[-1]

    def chain():
        h = F.layer_norm(y.float(), (D,), ps, pb, LN_EPS)
        h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp_min(
            1e-12) * D ** 0.5
        h = F.layer_norm(h, (D,), ss, sb, LN_EPS)
        h = h * (1 + scale[:, None, :].float()) + shift[:, None, :].float()
        return F.silu(h).to(y.dtype)

    return chain


def epilogue_case(dev, card, t, report, B, T, D, dtype):
    """Kernel 2 at one shape, fed scale and shift as the style block feeds
    them (the chunk halves of its Dense's [B, 2D] output): against the
    plain version, the same bits on a second call, times per call with
    grad (the autograd Function) and under inference mode (the sampling
    path), device times, the unfused chain of PyTorch calls in turns with
    the kernel, and the bound. Returns (err, ms, plain ms, bound ms, by,
    None): the chain is several calls, so no library time."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    y = t(B, T, D).to(dtype)
    sc, sh = t(B, 2 * D, s=0.3).to(dtype).chunk(2, dim=-1)
    vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
            t(D, s=0.1)]
    check(not sc.is_contiguous() and sc.stride() == (2 * D, 1),
          "performer_epilogue: scale is not the strided view")
    out = P.performer_epilogue(y, sc, sh, *vecs)
    torch.cuda.synchronize()
    ref = P.performer_epilogue_plain(y, sc, sh, *vecs)
    err = report("performer_epilogue", dtype, T, out, ref)
    same = torch.equal(out, P.performer_epilogue(y, sc, sh, *vecs))
    name = f"performer_epilogue {str(dtype)[6:]} B={B} T={T} D={D}"
    print(f"[A] {name} (scale and shift strided views, row stride {2 * D}): "
          f"a second call gives the same bits: {same}")
    check(same, f"{name} differs between two calls")
    kernel = lambda: P.performer_epilogue(y, sc, sh, *vecs)  # noqa: E731
    plain = lambda: P.performer_epilogue_plain(  # noqa: E731
        y, sc, sh, *vecs)
    chain = unfused_epilogue_chain(y, sc, sh, *vecs)
    k_ms, p_ms = paired_ms(kernel, plain)
    with torch.inference_mode():  # entered once, as a sampling forward does
        i_ms, c_ms = paired_ms(kernel, chain)
    c_err = (chain().float() - ref.float()).abs().max().item()
    # y read and the output written in y's dtype, scale and shift read,
    # the four LN vectors in f32; ~17 f32 operations per element (two
    # LayerNorms, L2, modulate, SiLU) at the f32 rate
    el = y.element_size()
    b_ms, b_by = bound(2 * B * T * D * el + 2 * B * D * el + 4 * D * 4,
                       17 * B * T * D, "f32")
    chunks = P.epilogue_chunks(B, T, P.epilogue_slots(0, D, dtype))
    print(f"[A] {name}: kernel {k_ms:.4f} ms per call with grad (the "
          f"autograd Function), {i_ms:.4f} ms under inference mode (the "
          f"launch path), plain {p_ms:.4f} ms (CUDA events, back-to-back); "
          f"device time kernel {device_ms(kernel)}, plain "
          f"{device_ms(plain)} (torch.profiler); the unfused chain of "
          f"PyTorch calls (F.layer_norm, L2, F.layer_norm, modulation, "
          f"F.silu in f32; several calls, {c_err:.3e} from the plain "
          f"version at most) {c_ms:.4f} ms per call, device time "
          f"{device_ms(chain)}; bound {b_ms:.4f} ms ({b_by}); {chunks} "
          f"blocks per batch row ({B * chunks} blocks) ({card})")
    if dtype == torch.bfloat16 and T == 196:
        sweep = {}
        for c in (1, 2, 3, 4, 6, 8, 12, 16):
            fn = (lambda c=c: P._launch_performer_epilogue(  # noqa: E731
                y, sc, sh, *vecs, chunks=c))
            check(torch.equal(fn(), out), f"{name}: {c} chunks give other "
                                          f"bits")
            sweep[c] = (time_ms(fn), device_ms(fn))
        print(f"[A] {name} by blocks per batch row C (forced; the same bits "
              f"for every C), ms per call (CUDA events) / device time "
              f"(torch.profiler): " + ", ".join(
                  f"{c}: {a:.4f} / {d}" for c, (a, d) in sweep.items())
              + f"; the wrapper takes {chunks} ({card})")
    return err, k_ms, p_ms, b_ms, b_by, None


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call: a CPU clock over ``n`` back-to-back
    calls with no synchronisation inside, then one."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def epilogue_launch_costs(dev, card, t, B, D):
    """Kernel 2's launch path, part by part, on the host's clock (bf16,
    T = 196, strided scale and shift): the whole wrapper with grad and
    under inference mode (entered once around all the calls, as a sampling
    forward enters it), and each of its steps alone; beside them the steps
    the earlier launch path took (the detailed check that builds its
    messages, a torch.cuda.device context, the stream object)."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.ops._build import library

    y = t(B, 196, D).to(torch.bfloat16)
    sc, sh = t(B, 2 * D, s=0.3).to(torch.bfloat16).chunk(2, dim=-1)
    vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
            t(D, s=0.1)]
    out = torch.empty_like(y)
    fn = library().mdm_performer_epilogue
    chunks = P.epilogue_chunks(B, 196, P.epilogue_slots(0, D,
                                                        torch.bfloat16))
    args = (y.data_ptr(), sc.data_ptr(), sh.data_ptr(), sc.stride(0),
            sh.stride(0), *[v.data_ptr() for v in vecs], out.data_ptr(), B,
            196, D, 1, chunks)
    raw = torch.cuda.current_stream(dev).cuda_stream

    def device_context():
        with torch.cuda.device(dev):
            pass

    wrapper = lambda: P.performer_epilogue(y, sc, sh, *vecs)  # noqa: E731
    with torch.inference_mode():
        print(f"[A] performer_epilogue bfloat16 B={B} T=196 host cost: the "
              f"wrapper under inference mode: {host_us(wrapper):.2f} us per "
              f"call ({card})")
    parts = {
        "the wrapper with grad (the autograd Function)": wrapper,
        "the one-pass check": lambda: P._epilogue_ok(y, sc, sh, vecs),
        "the detailed check (the earlier path's, messages built)":
            lambda: P._check_epilogue("performer_epilogue", y, sc, sh, vecs,
                                      views=True),
        "torch.empty_like(y)": lambda: torch.empty_like(y),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "the raw stream (torch._C._cuda_getCurrentRawStream)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "the stream object (torch.cuda.current_stream().cuda_stream, the "
        "earlier path's)": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "a torch.cuda.device context (the earlier path's)": device_context,
        "the C entry through ctypes (launches the kernel)":
            lambda: fn(*args, raw),
    }
    for label, f in parts.items():
        print(f"[A] performer_epilogue bfloat16 B={B} T=196 host cost: "
              f"{label}: {host_us(f):.2f} us per call ({card})")
    torch.cuda.synchronize()


def phase_a(dev, card):
    import torch
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops import activations as ACT
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(SEED)
    B, H, D, m, latent = 32, 4, 128, 128, 512
    results = {}

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def report(name, dtype, T, out, ref):
        out, ref = out.float(), ref.float()
        check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
        err = (out - ref).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.abs().clamp_min(1e-6)).max().item()
        if dtype == torch.float32:
            tol = F32_REL * ref.abs().max().item()
            ok = max_abs <= tol
            tol_s = f"max_abs <= {F32_REL:g} * max|plain| = {tol:.3e}"
        else:
            ok = bool((err <= BF16_REL * ref.abs() + BF16_ABS).all())
            tol_s = f"|err| <= 2^-7 |plain| + {BF16_ABS:g} elementwise"
        print(f"[A] {name} {str(dtype)[6:]} B={B} T={T}: max_abs_err="
              f"{max_abs:.3e} max_rel_err={max_rel:.3e} tol: {tol_s} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {dtype} T={T} outside tolerance")
        return max_abs

    for T in (196, 98):
        mask = ragged_mask(rng, B, T, dev)
        scale, bias = t(D, s=0.1, off=1.0), t(D, s=0.1)
        proj = t(D, m, s=D ** -0.25)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = t(B, T, 3 * H * D).to(dtype)
            out = P.favor_qkv(qkv, scale, bias, proj, mask)
            torch.cuda.synchronize()
            ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask)
            err = report("favor_qkv", dtype, T, out, ref)
            same = torch.equal(out, P.favor_qkv(qkv, scale, bias, proj, mask))
            print(f"[A] favor_qkv {str(dtype)[6:]} T={T}: a second call "
                  f"gives the same bits: {same}")
            check(same, "favor_qkv differs between two calls")
            kernel = lambda: P.favor_qkv(qkv, scale, bias, proj, mask)
            plain = lambda: P.favor_qkv_plain(qkv, scale, bias, proj, mask)
            k_ms, p_ms = paired_ms(kernel, plain)
            # inputs read once, output written once; the four [T, D] x
            # [D, m]-sized products of every (b, h)
            el = qkv.element_size()
            b_ms, b_by, floor_ms = favor_bound(
                B * T * 4 * H * D * el + (2 * D + D * m + B * T) * 4,
                4 * 2 * B * H * T * D * m)
            print(f"[A] favor_qkv {str(dtype)[6:]} B={B} T={T} "
                  f"({cluster_s(B * H, dev, 2)}): kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms per call (CUDA events); device time "
                  f"kernel {device_ms(kernel)}, plain {device_ms(plain)} "
                  f"(torch.profiler); bound {b_ms:.4f} ms ({b_by}, 3xTF32 "
                  f"on the tensor cores); the floor of IEEE f32 FMA "
                  f"products (PRs 1-5's design) {floor_ms:.4f} ms ({card})")
            results[("favor_qkv", dtype, T)] = (err, k_ms, p_ms, b_ms, b_by)
            if T != 196:
                continue
            if dtype == torch.bfloat16:
                cluster_sweep("A", "favor_qkv bf16 T=196", kernel,
                              lambda: P.favor_qkv(qkv[:2], scale, bias, proj,
                                                  mask[:2]), 2)
            # FAVOR_MXU_BF16=1: one bf16 pass per product, against the
            # plain version with bf16 operands (an operand the two sides
            # round from f32 values summed in another order may land one
            # bf16 ulp apart: held at bf16 resolution, 2^-8 of max|plain|)
            os.environ["FAVOR_MXU_BF16"] = "1"
            try:
                out = P.favor_qkv(qkv, scale, bias, proj, mask)
                torch.cuda.synchronize()
                k_ms = time_ms(kernel)
            finally:
                del os.environ["FAVOR_MXU_BF16"]
            ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask,
                                    product=P.bf16_operand_product)
            diff = (out.float() - ref.float()).abs()
            floor = 2 ** -8 * ref.float().abs().max().item()
            ok = bool((diff <= (BF16_REL * ref.float().abs() if dtype
                                == torch.bfloat16 else 0) + floor).all())
            print(f"[A] favor_qkv {str(dtype)[6:]} T={T} FAVOR_MXU_BF16=1: "
                  f"max_abs_err={diff.max().item():.3e} against the plain "
                  f"version with bf16 operands (tol {floor:.3e}"
                  + (" + one bf16 ulp" if dtype == torch.bfloat16 else "")
                  + f") -> {'ok' if ok else 'FAIL'}; kernel {k_ms:.4f} ms "
                  f"per call ({card})")
            check(ok, f"favor_qkv FAVOR_MXU_BF16=1 {dtype} outside tolerance")

        for dtype in (torch.bfloat16, torch.float32):
            results[("performer_epilogue", dtype, T)] = epilogue_case(
                dev, card, t, report, B, T, latent, dtype)
    results.update(favor_split_case(dev, card, t, report, rng, B, H, D, m))
    epilogue_launch_costs(dev, card, t, B, latent)
    # registers and spills of kernel 2, as ptxas reported them in this
    # run's build: none may spill at D = 512
    from motiondiffusion_moe_tpu_torch.ops import _build

    usage = _build.resource_usage("performer_epilogue_kernel")
    for line in usage:
        print(f"[A] ptxas: {line}")
    if not usage:
        print("[A] ptxas: not reported (the library came from the cache)")
    spills = [u for u in usage
              if "Li16E" in u and " 0 bytes spill stores" not in u]
    check(not spills, "performer_epilogue_kernel spills at D = 512")

    # the bf16 activations at widths the flagship gives them: the style
    # blocks' silu, the exact cross-attention FFN's gelu after ffn_0 (with
    # its bias), a cross-attention gate's sigmoid
    cases = (("silu", (B, 196, latent), False, F.silu),
             ("gelu", (B * 196, 4 * latent), True, None),
             ("sigmoid", (latent,), False, torch.sigmoid))
    # f32 operations per value (exp and tanh counted once): silu neg, exp,
    # add, divide, multiply; gelu the bias add, 3 multiplies and an add for
    # the cubic term, a multiply, tanh, an add and 2 multiplies; sigmoid 4.
    # The gradient pass redoes the forward's steps up to s (or tanh) and
    # adds those of the transposed program: silu 8 more, gelu 14, sigmoid 3
    ops = {"silu": 5, "gelu": 10, "sigmoid": 4}
    grad_ops = {"silu": 11, "gelu": 24, "sigmoid": 7}
    for name, shape, with_bias, library in cases:
        x = t(*shape, s=3.0).to(torch.bfloat16)
        b = t(shape[-1]).to(torch.bfloat16) if with_bias else None
        fn, plain = getattr(ACT, name), getattr(ACT, f"{name}_plain")
        out = fn(x, b)
        torch.cuda.synchronize()
        label = (f"{name} bfloat16 {list(shape)}"
                 + (" + Dense bias" if with_bias else ""))
        err = compare_flips("A", label, out, plain(x, b), ACT_FLIP_SHARE)
        k_ms, p_ms = paired_ms(lambda: fn(x, b), lambda: plain(x, b))
        n, bias_bytes = x.numel(), 2 * shape[-1] if with_bias else 0
        b_ms, b_by = bound(2 * 2 * n + bias_bytes, ops[name] * n, "f32")
        # PyTorch's own function rounds once: not the same function, so
        # no library time; its time is printed beside as a yardstick only
        side = ("no single PyTorch call adds the bias and applies it"
                if library is None else
                f"PyTorch's own {name} {time_ms(lambda: library(x)):.4f} "
                f"ms (one rounding: another function)")
        print(f"[A] {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per "
              f"call (CUDA events), {side}; device time kernel "
              f"{device_ms(lambda: fn(x, b))}, plain "
              f"{device_ms(lambda: plain(x, b))} (torch.profiler); bound "
              f"{b_ms:.4f} ms ({b_by}) ({card})")
        results[name] = (err, k_ms, p_ms, b_ms, b_by, None)

        # the gradient pass (the backward of the bf16 wrappers in training)
        g = t(*shape).to(torch.bfloat16)
        kernel = lambda: ACT.activation_grad(name, x, g, b)  # noqa: E731
        plain = lambda: ACT.activation_grad_plain(  # noqa: E731
            name, x, g, b)
        out = kernel()
        torch.cuda.synchronize()
        err = compare_flips("A", f"{label} gradient pass", out, plain(),
                            ACT_FLIP_SHARE)
        k_ms, p_ms = paired_ms(kernel, plain)
        b_ms, b_by = bound(3 * 2 * n + bias_bytes, grad_ops[name] * n, "f32")
        print(f"[A] {label} gradient pass (dx): kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms per call (CUDA events), no PyTorch call takes "
              f"JAX's steps; device time kernel {device_ms(kernel)}, plain "
              f"{device_ms(plain)} (torch.profiler); bound {b_ms:.4f} ms "
              f"({b_by}) ({card})")
        results[f"{name}_grad"] = (err, k_ms, p_ms, b_ms, b_by, None)
    return results


SPLIT_T = 196   # the flagship's frames, cut over 2 and 4 seq ranks in A


def favor_split_case(dev, card, t, report, rng, B, H, D, m):
    """Kernel 1 in its two seq launches at the flagship's shapes: T =
    SPLIT_T cut over 2 and 4 seq ranks (ExpertMesh.frames: 98 / 98 and
    50 / 50 / 48 / 48), bf16 and f32, the ragged mask. Each cut's moments
    are summed on the card, each cut's apply reads the sum, and the cuts'
    outputs, concatenated, are held to the whole kernel 1 and to the plain
    split of the same cuts by phase A's rule (``report``). Both launches
    are timed in bf16 at the 4-way cut's first shape (50 frames, O1's seq
    4 rank) against their plain versions and their bounds (three TF32 passes: the moments' two products, the k
    logits and phi(k)^T v; the apply's three, the q and k logits and phi(q)
    kv). Then kernel 8's two launches against favor_attention over the same
    cuts (f32, no mask: its masked rows divide by eps, and their size would
    set the tolerance). Returns {(name, dtype, T_cut): (max abs err, ms,
    plain ms, bound ms, bound by, None)}."""
    import torch
    from types import SimpleNamespace
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh

    T = SPLIT_T
    mask = ragged_mask(rng, B, T, dev)
    scale, bias = t(D, s=0.1, off=1.0), t(D, s=0.1)
    proj = t(D, m, s=D ** -0.25)
    ln = (scale, bias, proj)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv = t(B, T, 3 * H * D).to(dtype)
        whole = P.favor_qkv(qkv, *ln, mask)
        el = qkv.element_size()
        for sp in (2, 4):
            cuts = [ExpertMesh.frames(SimpleNamespace(sp=sp), T, s)
                    for s in range(sp)]
            parts = [(qkv[:, a:b].contiguous(), mask[:, a:b].contiguous())
                     for a, b in cuts]
            with torch.inference_mode():
                kv = sum(P.favor_qkv_moments(x, *ln, mk) for x, mk in parts)
                got = torch.cat([P.favor_qkv_apply(x, kv, *ln, mk)
                                 for x, mk in parts], 1)
                kv_p = sum(P.favor_qkv_moments_plain(x, *ln, mk)
                           for x, mk in parts)
                plain = torch.cat([P.favor_qkv_apply_plain(x, kv_p, *ln, mk)
                                   for x, mk in parts], 1)
            torch.cuda.synchronize()
            sizes = "/".join(str(b - a) for a, b in cuts)
            report(f"favor_qkv split {sizes} vs whole favor_qkv", dtype, T,
                   got, whole)
            err = report(f"favor_qkv split {sizes} vs plain split", dtype, T,
                         got, plain)
            if sp != 4 or dtype != torch.bfloat16:
                continue
            x, mk = parts[0]
            Tc = x.shape[1]
            kvc = kv.contiguous()
            fns = {
                "favor_qkv_moments": (
                    lambda: P.favor_qkv_moments(x, *ln, mk),
                    lambda: P.favor_qkv_moments_plain(x, *ln, mk),
                    # k, v read; kv written; two products
                    B * Tc * 2 * H * D * el + B * H * m * D * 4,
                    2 * 2 * B * H * Tc * D * m),
                "favor_qkv_apply": (
                    lambda: P.favor_qkv_apply(x, kvc, *ln, mk),
                    lambda: P.favor_qkv_apply_plain(x, kvc, *ln, mk),
                    # q, k and kv read; the output written; three products
                    B * Tc * 3 * H * D * el + B * H * m * D * 4,
                    3 * 2 * B * H * Tc * D * m)}
            for name, (kernel, plain_fn, nbytes, flops) in fns.items():
                with torch.inference_mode():
                    k_ms, p_ms = paired_ms(kernel, plain_fn)
                    dev_k, dev_p = device_ms(kernel), device_ms(plain_fn)
                b_ms, b_by, _ = favor_bound(
                    nbytes + (2 * D + D * m + B * Tc) * 4, flops)
                print(f"[A] {name} {str(dtype)[6:]} B={B} T={Tc} (a rank of "
                      f"{sizes}; {cluster_s(B * H, dev, 2)}): kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call (CUDA "
                      f"events); device time kernel {dev_k}, plain {dev_p} "
                      f"(torch.profiler); bound {b_ms:.4f} ms ({b_by}, "
                      f"3xTF32 on the tensor cores); no PyTorch call "
                      f"computes it ({card})")
                out[(name, dtype, Tc)] = (err, k_ms, p_ms, b_ms, b_by, None)

    # kernel 8 (the unfused Performer's core) in the same two launches
    q, k, v = (t(B, H, T, D) for _ in range(3))
    q, k = (x / x.norm(dim=-1, keepdim=True) for x in (q, k))
    whole = P.favor_attention(q, k, v, proj)
    for sp in (2, 4):
        cuts = [ExpertMesh.frames(SimpleNamespace(sp=sp), T, s)
                for s in range(sp)]
        parts = [tuple(x[:, :, a:b].contiguous() for x in (q, k, v))
                 + (None,) for a, b in cuts]
        with torch.inference_mode():
            kv = sum(P.favor_attention_moments(kc, vc, proj, mc)
                     for _, kc, vc, mc in parts)
            got = torch.cat([P.favor_attention_apply(qc, kc, kv, proj, mc)
                             for qc, kc, _, mc in parts], 2)
        torch.cuda.synchronize()
        sizes = "/".join(str(b - a) for a, b in cuts)
        report(f"favor_attention split {sizes} vs whole favor_attention",
               torch.float32, T, got, whole)
        qc, kc, vc, mc = parts[0]
        with torch.inference_mode():
            m_ms = time_ms(lambda: P.favor_attention_moments(kc, vc, proj,
                                                             mc))
            a_ms = time_ms(lambda: P.favor_attention_apply(qc, kc, kv, proj,
                                                           mc))
        print(f"[A] favor_attention_moments / _apply float32 B={B} "
              f"T={qc.shape[2]} (a rank of {sizes}): {m_ms:.4f} / "
              f"{a_ms:.4f} ms per call (CUDA events) ({card})")
    return out


def build_flagship(cfg):
    """The flagship denoiser on the CPU with seeded weights; the zero-init
    leaves (MoE gates, style-block output kernels, the head) get a small
    seeded draw, or the denoiser would output exactly zero."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    return perturb_zero_init(init_weights(MotionTransformer(cfg.model), SEED))


def perturb_zero_init(model):
    """A small seeded draw into the denoiser's zero-init leaves (MoE gates,
    style-block output kernels, the head); returns ``model``."""
    import torch

    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            zero_init = (name.endswith("gate.weight")
                         or name.endswith("out_kernel")
                         or name == "out.weight")
            if zero_init and not p.any():
                p.normal_(0.0, 0.02, generator=g)
    return model


def denoiser_inputs(cfg, dev, B=32, tokenize=None):
    """One denoiser batch of the CFG-doubled flagship micro-batch: x, t and
    lengths on the card, and the token ids of 16 prompts and 16 empty ones
    (``tokenize``'s, else the hash encoder's)."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)

    if tokenize is None:
        tokenize = lambda texts: hash_tokenize(  # noqa: E731
            texts, cfg.model.text_max_tokens)

    rng = np.random.default_rng(SEED + 2)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    x = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=B))
    length = torch.from_numpy(rng.integers(1, T + 1, size=B))
    length[0] = T
    prompts = [f"a person walks forward and turns {i}" for i in range(B // 2)]
    ids = torch.from_numpy(tokenize(prompts + [""] * (B // 2)))
    return [a.to(dev) for a in (x, t, length)], ids.to(dev)


def rel_rms(a, b) -> float:
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def phase_b(cfg, model, dev):
    """One full-width forward through the kernels and one with
    use_kernels=False, in f32 compute (the kernels' own precision: tight)
    and in the flagship's bf16 compute, where both are held to the f32
    result: the kernels may cost no more than bf16 compute itself does."""
    import dataclasses

    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    rng = np.random.default_rng(SEED + 2)
    args, ids = denoiser_inputs(cfg, dev)
    B, T, F = args[0].shape

    def both(m):
        with torch.inference_mode():
            m.set_use_kernels(True)
            out_k = m(*args, text_ids=ids)
            m.set_use_kernels(False)
            out_p = m(*args, text_ids=ids)
            m.set_use_kernels(True)
        torch.cuda.synchronize()
        for out in (out_k, out_p):
            check(out.shape == (B, T, F), f"denoiser output {out.shape}")
            check(bool(torch.isfinite(out).all()), "denoiser non-finite")
        return out_k, out_p

    cfg32 = dataclasses.replace(cfg.model, dtype="float32")
    m32 = MotionTransformer(cfg32).to(dev).eval()
    m32.load_state_dict(model.state_dict())
    k32, ref = both(m32)
    sample_f32_through_both(cfg, m32, dev, rng)
    del m32
    rel = rel_rms(k32, ref)
    ok = rel <= DENOISER_F32_REL_RMS
    print(f"[B] flagship denoiser float32 compute B={B} T={T}: kernels vs "
          f"use_kernels=False rel_rms={rel:.3e} max_abs="
          f"{(k32 - ref).abs().max().item():.3e} (|out| rms "
          f"{ref.pow(2).mean().sqrt().item():.3e}); tol rel_rms <= "
          f"{DENOISER_F32_REL_RMS:g} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (float32) kernels vs plain")

    k16, p16 = both(model)
    err_k, err_p = rel_rms(k16, ref), rel_rms(p16, ref)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    ok = err_k <= tol
    print(f"[B] flagship denoiser bfloat16 compute B={B} T={T}: rel_rms to "
          f"the f32 result: kernels {err_k:.3e}, use_kernels=False "
          f"{err_p:.3e}; kernels vs use_kernels=False "
          f"{rel_rms(k16, p16):.3e}; tol kernels <= "
          f"{DENOISER_BF16_FACTOR:g} x use_kernels=False + "
          f"{DENOISER_BF16_FLOOR:g} = {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (bfloat16) kernels vs plain")


def sample_f32_through_both(cfg, m32, dev, rng):
    """The whole sampler on a small input at full width: 3 DPM-Solver++
    steps for 2 prompts in f32 compute, through the kernels and through
    their plain versions, from the same injected noise."""
    import dataclasses

    import torch
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    T, F = cfg.model.max_frames, cfg.model.input_feats
    pipe = GenerationPipeline(dataclasses.replace(cfg, model=m32.config),
                              m32, sampler="dpm", num_inference_steps=3,
                              micro_batch=2, device=dev)
    tok = cfg.model.text_max_tokens
    ids_c = torch.from_numpy(hash_tokenize(["a person walks", "a person "
                                            "jumps twice"], tok))
    ids_u = torch.from_numpy(hash_tokenize(["", ""], tok))
    noise = torch.from_numpy(rng.standard_normal((2, T, F)).astype(
        np.float32))
    lengths = torch.tensor([T, 77])
    outs = []
    for flag in (True, False):
        m32.set_use_kernels(flag)
        outs.append(pipe.sample(ids_c, ids_u, lengths, noise=noise))
    m32.set_use_kernels(True)
    torch.cuda.synchronize()
    out_k, out_p = outs
    check(out_k.shape == (2, T, F) and bool(torch.isfinite(out_k).all()),
          "f32 sample shape or non-finite")
    err = (out_k - out_p).abs().max().item()
    tol = SAMPLE_F32_REL * out_p.abs().max().item()
    ok = err <= tol
    print(f"[B] flagship dpm3 sample, 2 prompts, float32 compute: kernels vs "
          f"use_kernels=False max_abs={err:.3e} (max|sample| "
          f"{out_p.abs().max().item():.3e}); tol {SAMPLE_F32_REL:g} x "
          f"max|sample| = {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "f32 sample kernels vs plain")


def activation_launches(model_cfg, moe_fused: bool) -> dict:
    """Launches of each bf16 activation kernel in one denoiser forward. Per
    decoder layer: silu on the embeddings of its four style blocks and in
    the bodies of the two that are not a Performer's; gelu after the two
    proj_out_0, the skip and ffn_0, and in each MoE branch unless the fused
    MoE kernel holds it; sigmoid on the two cross-attention gates. Once:
    silu in the time embedding, the time MLP and the fusion MLP, sigmoid on
    the fusion gate."""
    L = 2 * model_cfg.num_layers
    moe = 0 if moe_fused else model_cfg.moe_num_branches
    return {"silu": 3 + 6 * L, "gelu": (4 + moe) * L, "sigmoid": 1 + 2 * L}


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_c(cfg, model, dev, card):
    import torch
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.motion.recover import recover_from_ric
    from motiondiffusion_moe_tpu_torch.ops import activations as ACT
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.serve import make_server

    counted = (P.favor_qkv, P.performer_epilogue, ACT.silu, ACT.gelu,
               ACT.sigmoid)
    pipe = GenerationPipeline(cfg, model, sampler="dpm",
                              num_inference_steps=20, micro_batch=16,
                              param_dtype="bfloat16", device=dev)
    pipe.normalizer = MotionNormalizer.identity(cfg.data.dim_pose)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    samples = []
    sample = pipe.sample

    def counted_sample(*a, **k):
        samples.append(1)
        return sample(*a, **k)

    pipe.sample = counted_sample
    # warm-up outside the counted run (cuBLAS / cuDNN handles, allocator)
    pipe.generate(["warm up"], [T])
    samples.clear()

    srv = make_server(pipe, port=0, max_batch=64)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for c in counted:
            c.launches = 0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health.get("ok") is True, f"/healthz {health}")
        print(f"[C] /healthz {health}")

        results = {}

        def post_into(key, payload):
            results[key] = _post(url + "/generate", payload)

        # A occupies the device; B and C arrive while it runs and are merged
        first = threading.Thread(target=post_into, args=(
            "a", {"texts": ["a person runs in a circle"] * 4,
                  "lengths": [T] * 4}))
        first.start()
        time.sleep(0.05)
        pair = [threading.Thread(target=post_into, args=(k, {
            "texts": [txt], "lengths": [n]})) for k, txt, n in (
                ("b", "a person waves with the left hand", 120),
                ("c", "a person jumps twice", 64))]
        for th2 in pair:
            th2.start()
        for th2 in [first] + pair:
            th2.join(timeout=600)
            check(not th2.is_alive(), "request thread hung")
        mixed_lens = [1, 57, 98, 196, 133]
        post_into("mixed", {"texts": ["walk", "kick the ball hard", "",
                                      "dance slowly", "sit down"],
                            "lengths": mixed_lens})
        seeded = {"texts": ["a person bows", "a person climbs stairs"],
                  "lengths": [150, 196], "seed": 1234}
        post_into("s1", seeded)
        post_into("s2", seeded)

        expect = {"a": [T] * 4, "b": [120], "c": [64], "mixed": mixed_lens,
                  "s1": [150, 196], "s2": [150, 196]}
        for key, lens in expect.items():
            status, body = results[key]
            check(status == 200, f"request {key}: HTTP {status}")
            motions = [np.asarray(mo, dtype=np.float32)
                       for mo in body["motions"]]
            check([list(mo.shape) for mo in motions] == [[n, F] for n in lens],
                  f"request {key}: shapes {body['shapes']}")
            check(all(np.isfinite(mo).all() for mo in motions),
                  f"request {key}: non-finite motion")
            joints = [recover_from_ric(torch.from_numpy(mo).to(dev),
                                       cfg.data.num_joints) for mo in motions]
            check(all(bool(torch.isfinite(j).all()) for j in joints),
                  f"request {key}: non-finite joints")
            rms = np.sqrt(np.mean(np.concatenate(
                [mo.ravel() for mo in motions]) ** 2))
            print(f"[C] request {key}: HTTP 200, shapes {body['shapes']}, "
                  f"batched={body['batched']}, step_ms={body['step_ms']}, "
                  f"motion rms {rms:.3f}, joints {tuple(joints[0].shape)} "
                  "finite")
        check(results["b"][1]["batched"] == 2
              and results["c"][1]["batched"] == 2,
              "the batcher did not merge the two concurrent requests")
        check(results["s1"][1]["motions"] == results["s2"][1]["motions"],
              "seeded repeats differ")
        print("[C] concurrent seedless requests merged into one call; "
              "seeded repeats identical")
        fwd = len(samples) * pipe.forwards_per_sample
        launches = {c.__name__: c.launches for c in counted}
        n_perf = 2 * 2 * cfg.model.num_layers  # Performers per forward
        per_fwd = {"favor_qkv": n_perf, "performer_epilogue": n_perf,
                   **activation_launches(cfg.model, moe_fused=False)}
        print(f"[C] {len(samples)} micro-batch samples x "
              f"{pipe.forwards_per_sample} forwards = {fwd} forwards; "
              f"launches {launches}; expected per forward {per_fwd}")
        for name, n in launches.items():
            check(n == per_fwd[name] * fwd, f"{name} launched {n} times, "
                                            f"expected {per_fwd[name] * fwd}")
    finally:
        srv.shutdown()
        srv.server_close()
    pipe.sample = sample

    args, ids = denoiser_inputs(cfg, dev)

    def forward():
        with torch.inference_mode():
            pipe.model(*args, text_ids=ids)

    print(f"[C] one denoiser forward (B=32, bf16, torch.profiler): "
          f"{kernels_per_call(forward)} ({card})")

    prompts = [f"a person performs action number {i}" for i in range(16)]
    timings = {}
    for name, sampler, steps in (("dpm20", "dpm", 20), ("ddim50", "ddim", 50)):
        p2 = GenerationPipeline(cfg, model, sampler=sampler,
                                num_inference_steps=steps, micro_batch=16,
                                param_dtype="bfloat16", device=dev)
        p2.generate(prompts, [T] * 16)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = p2.generate(prompts, [T] * 16,
                          generator=torch.Generator(dev).manual_seed(7))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        check(all(np.isfinite(o).all() for o in out), f"{name} non-finite")
        timings[name] = s
        print(f"[C] {name} generate 16 prompts x {T} frames (CFG, micro_batch "
              f"16, bf16 weights): {s:.3f} s, {s / 16:.4f} s/motion, "
              f"{16 / s:.2f} motions/s ({card})")
    return launches, timings


def phase_d1(dev, card):
    """The backward kernels against their plain versions at the training
    shapes."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(SEED + 10)
    B, H, D, m, latent = 32, 4, 128, 128, 512
    results = {}

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def compare(name, outs, refs, dtypes):
        worst = 0.0
        for i, (o, r, dt) in enumerate(zip(outs, refs, dtypes)):
            if r is None:
                check(o is None, f"{name} output {i} should be None")
                continue
            o, r = o.float(), r.float()
            check(bool(torch.isfinite(o).all()), f"{name} output {i} "
                                                 "non-finite")
            err = (o - r).abs()
            floor = BWD_FLOOR * r.abs().max().item()
            if dt == torch.float32:
                ok = err.max().item() <= floor
            else:
                ok = bool((err <= 2 ** -7 * r.abs() + floor).all())
            print(f"[D1]   {name} output {i} {str(dt)[6:]}: max_abs_err="
                  f"{err.max().item():.3e} (max|plain| "
                  f"{r.abs().max().item():.3e}) -> {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} output {i} outside tolerance")
            worst = max(worst, err.max().item())
        return worst

    tol = (f"f32: max_abs <= {BWD_FLOOR:g} max|plain|; bf16: |err| <= 2^-7 "
           f"|plain| + {BWD_FLOOR:g} max|plain|")
    print(f"[D1] tolerance {tol}")
    for T in (196, 98):
        mask = ragged_mask(rng, B, T, dev)
        scale, bias = t(D, s=0.1, off=1.0), t(D, s=0.1)
        proj = t(D, m, s=D ** -0.25)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = t(B, T, 3 * H * D).to(dtype)
            g = t(B, T, H * D).to(dtype)
            for need in (False, True):
                name = (f"favor_qkv_bwd {str(dtype)[6:]} T={T} "
                        f"d(proj)={'yes' if need else 'no'}")
                out = P.favor_qkv_bwd(qkv, scale, bias, proj, mask, g,
                                      need_dproj=need)
                torch.cuda.synchronize()
                ref = P.favor_qkv_bwd_plain(qkv, scale, bias, proj, mask, g,
                                            need_dproj=need)
                err = compare(name, out, ref, (dtype, torch.float32,
                                               torch.float32, torch.float32))
                if dtype == torch.bfloat16 and not need:  # the train path
                    kernel = lambda: P.favor_qkv_bwd(  # noqa: E731
                        qkv, scale, bias, proj, mask, g, need_dproj=False)
                    plain = lambda: P.favor_qkv_bwd_plain(  # noqa: E731
                        qkv, scale, bias, proj, mask, g, need_dproj=False)
                    again = kernel()
                    same = all(torch.equal(a, o) for a, o in
                               zip(again[:3], out[:3]))
                    print(f"[D1] {name}: a second call gives the same bits: "
                          f"{same}")
                    check(same, "favor_qkv_bwd differs between two calls")
                    k_ms, p_ms = paired_ms(kernel, plain, iters=10)
                    # qkv and g read, d qkv and d(LN) written; the forward's
                    # four [T, D] x [D, m]-sized products recomputed and six
                    # in the backward
                    b_ms, b_by, floor_ms = favor_bound(
                        B * T * 7 * H * D * 2 + (4 * D + D * m + B * T) * 4,
                        10 * 2 * B * H * T * D * m)
                    print(f"[D1] {name} ({cluster_s(B * H, dev, 1)}): "
                          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per "
                          f"call (CUDA events); device time kernel "
                          f"{device_ms(kernel, 10)}, plain "
                          f"{device_ms(plain, 10)} (torch.profiler); bound "
                          f"{b_ms:.4f} ms ({b_by}, 3xTF32 on the tensor "
                          f"cores); the floor of IEEE f32 FMA products (PRs "
                          f"1-5's design) {floor_ms:.4f} ms ({card})")
                    results[("favor_qkv_bwd", T)] = (err, k_ms, p_ms, b_ms,
                                                     b_by)
                    if T == 196:
                        cluster_sweep("D1", name, kernel,
                                      lambda: P.favor_qkv_bwd(
                                          qkv[:2], scale, bias, proj,
                                          mask[:2], g[:2], need_dproj=False),
                                      1)

        y, g = t(B, T, latent).to(torch.bfloat16), t(B, T, latent).to(
            torch.bfloat16)
        sc = t(B, latent, s=0.3).to(torch.bfloat16)
        sh = t(B, latent, s=0.3).to(torch.bfloat16)
        vecs = [t(latent, s=0.1, off=1.0), t(latent, s=0.1),
                t(latent, s=0.1, off=1.0), t(latent, s=0.1)]
        name = f"performer_epilogue_bwd bfloat16 T={T}"
        out = P.performer_epilogue_bwd(y, sc, sh, *vecs, g)
        torch.cuda.synchronize()
        ref = P.performer_epilogue_bwd_plain(y, sc, sh, *vecs, g)
        err = compare(name, out, ref, [torch.bfloat16] * 3
                      + [torch.float32] * 4)
        kernel = lambda: P.performer_epilogue_bwd(  # noqa: E731
            y, sc, sh, *vecs, g)
        plain = lambda: P.performer_epilogue_bwd_plain(  # noqa: E731
            y, sc, sh, *vecs, g)
        k_ms, p_ms = paired_ms(kernel, plain, iters=10)
        # y and g read, dy written; scale, shift, their gradients and the
        # eight LN vectors; ~50 f32 operations per element
        b_ms, b_by = bound(3 * B * T * latent * 2 + 4 * B * latent * 2
                           + 8 * latent * 4, 50 * B * T * latent, "f32")
        print(f"[D1] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per "
              f"call (CUDA events); device time kernel "
              f"{device_ms(kernel, 10)}, plain "
              f"{device_ms(plain, 10)} (torch.profiler); bound {b_ms:.4f} "
              f"ms ({b_by}) ({card})")
        again = kernel()
        same = all(torch.equal(a, o) for a, o in zip(again, out))
        print(f"[D1] {name}: a second call gives the same bits: {same}")
        check(same, "performer_epilogue_bwd differs between two calls")
        cluster = P.epilogue_bwd_cluster(B, T, latent, torch.bfloat16)
        print(f"[D1] {name} (T no multiple of 32; {cluster} blocks of "
              f"{-(-T // cluster)} rows per batch row, one thread-block "
              f"cluster): device time per launch "
              f"{device_ms_by_kernel(kernel, 10)} (torch.profiler) ({card})")
        results[("performer_epilogue_bwd", T)] = (err, k_ms, p_ms, b_ms,
                                                  b_by)
    results.update(favor_bwd_split_case(dev, card, t, compare, rng, B, H,
                                        D, m))
    # registers and spills of the main kernel, as ptxas reported them in
    # this run's build: none may spill at D = 512
    from motiondiffusion_moe_tpu_torch.ops import _build

    usage = _build.resource_usage("performer_epilogue_bwd_kernel")
    for line in usage:
        print(f"[D1] ptxas: {line}")
    if not usage:
        print("[D1] ptxas: not reported (the library came from the cache)")
    spills = [u for u in usage
              if "Li16E" in u and " 0 bytes spill stores" not in u]
    check(not spills, "performer_epilogue_bwd_kernel spills at D = 512")
    return results


def favor_bwd_split_case(dev, card, t, compare, rng, B, H, D, m):
    """Kernel 3 in its three seq launches at the training shapes: T =
    SPLIT_T cut over 2 and 4 seq ranks (98 / 98 and 50 / 50 / 48 / 48),
    bf16 and f32, the ragged mask, d(proj) asked for. Each cut's kv is
    summed on the card, each cut's q launch reads the sum, their g_kv are
    summed, each cut's k launch reads that; d(qkv) concatenated and d(ln),
    d(proj) summed are held to the whole kernel 3 and to the plain split of
    the same cuts by D1's rule (``compare``). The three launches are timed
    in bf16 at a seq 4 rank's 50 frames (d(proj) not asked for, as in
    training) against their plain steps and their bounds. Returns
    {(name, T_cut): (max abs err, ms, plain ms, bound ms, bound by,
    None)}."""
    import torch
    from types import SimpleNamespace
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh

    T = SPLIT_T
    mask = ragged_mask(rng, B, T, dev)
    scale, bias = t(D, s=0.1, off=1.0), t(D, s=0.1)
    proj = t(D, m, s=D ** -0.25)
    ln = (scale, bias, proj)

    def total(ts):  # the seq ranks' sum, on the card
        return torch.stack(list(ts)).sum(0)

    def kernels(parts):
        kvs, splits = zip(*(P.favor_qkv_bwd_kv(x, *ln, mk)
                            for x, mk, _ in parts))
        kv = total(kvs)
        g_kv = total(P.favor_qkv_bwd_q(sp, kv, gc)
                     for sp, (_, _, gc) in zip(splits, parts))
        outs = [P.favor_qkv_bwd_k(sp, g_kv) for sp in splits]
        return (torch.cat([o[0] for o in outs], 1),
                *(total(o[i] for o in outs) for i in (1, 2, 3)))

    def plain(parts):
        kv = total(P.favor_qkv_bwd_kv_plain(x, *ln, mk) for x, mk, _ in parts)
        qs = [P.favor_qkv_bwd_q_plain(x, kv, *ln, mk, gc)
              for x, mk, gc in parts]
        g_kv = total(q[0] for q in qs)
        outs = [P.favor_qkv_bwd_k_plain(x, g_kv, *ln, mk, q[1])
                for (x, mk, _), q in zip(parts, qs)]
        return (torch.cat([o[0] for o in outs], 1),
                *(total(o[i] for o in outs) for i in (1, 2, 3)))

    out = {}
    f32 = torch.float32
    for dtype in (torch.bfloat16, f32):
        qkv = t(B, T, 3 * H * D).to(dtype)
        g = t(B, T, H * D).to(dtype)
        whole = P.favor_qkv_bwd(qkv, *ln, mask, g)
        el = qkv.element_size()
        for sp in (2, 4):
            cuts = [ExpertMesh.frames(SimpleNamespace(sp=sp), T, s)
                    for s in range(sp)]
            parts = [(qkv[:, a:b].contiguous(), mask[:, a:b].contiguous(),
                      g[:, a:b].contiguous()) for a, b in cuts]
            got = kernels(parts)
            torch.cuda.synchronize()
            ref = plain(parts)
            sizes = "/".join(str(b - a) for a, b in cuts)
            dts = (dtype, f32, f32, f32)
            compare(f"favor_qkv_bwd split {sizes} {str(dtype)[6:]} vs whole "
                    "favor_qkv_bwd", got, whole, dts)
            err = compare(f"favor_qkv_bwd split {sizes} {str(dtype)[6:]} vs "
                          "plain split", got, ref, dts)
            if sp != 4 or dtype != torch.bfloat16:
                continue
            x, mk, gc = parts[0]
            Tc = x.shape[1]
            no = dict(need_dproj=False)
            kv = total(P.favor_qkv_bwd_kv_plain(y, *ln, c)
                       for y, c, _ in parts)
            _, split = P.favor_qkv_bwd_kv(x, *ln, mk, **no)
            g_kv = P.favor_qkv_bwd_q(split, kv, gc)
            part = P.favor_qkv_bwd_q_plain(x, kv, *ln, mk, gc, **no)[1]
            # the bytes each launch's function must move: its rows, kv and
            # g_kv; the scratch and the accumulators that this design hands
            # between launches are not counted
            rows, kvb = B * Tc * H * D * el, B * H * m * D * 4
            fns = {  # kernel, plain, bytes, products
                # k, v read; kv written; two products
                "favor_qkv_bwd_kv": (
                    lambda: P.favor_qkv_bwd_kv(x, *ln, mk, **no),
                    lambda: P.favor_qkv_bwd_kv_plain(x, *ln, mk),
                    2 * rows + kvb, 2),
                # q, k, g and kv read; d(q) and g_kv written; five products
                "favor_qkv_bwd_q": (
                    lambda: P.favor_qkv_bwd_q(split, kv, gc),
                    lambda: P.favor_qkv_bwd_q_plain(x, kv, *ln, mk, gc,
                                                    **no),
                    4 * rows + 2 * kvb, 5),
                # k, v and g_kv read; d(k), d(v) and d(ln) written; three
                "favor_qkv_bwd_k": (
                    lambda: P.favor_qkv_bwd_k(split, g_kv),
                    lambda: P.favor_qkv_bwd_k_plain(x, g_kv, *ln, mk, part,
                                                    **no),
                    4 * rows + kvb + 2 * D * 4, 3)}
            for name, (kernel, plain_fn, nbytes, products) in fns.items():
                k_ms, p_ms = paired_ms(kernel, plain_fn, iters=10)
                b_ms, b_by, _ = favor_bound(
                    nbytes + (2 * D + D * m + B * Tc) * 4,
                    products * 2 * B * H * Tc * D * m)
                print(f"[D1] {name} {str(dtype)[6:]} B={B} T={Tc} (a rank "
                      f"of {sizes}; {cluster_s(B * H, dev, 1)}): kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call (CUDA "
                      f"events); device time kernel {device_ms(kernel, 10)}"
                      f", plain {device_ms(plain_fn, 10)} (torch.profiler); "
                      f"bound {b_ms:.4f} ms ({b_by}, 3xTF32 on the tensor "
                      f"cores); no PyTorch call computes it ({card})")
                out[(name, Tc)] = (err, k_ms, p_ms, b_ms, b_by, None)
            whole_c = lambda: P.favor_qkv_bwd(  # noqa: E731
                x, *ln, mk, gc, need_dproj=False)
            print(f"[D1] the whole favor_qkv_bwd on the same 50 frames (one "
                  f"rank's rows, kv and g_kv not summed): "
                  f"{time_ms(whole_c, 10):.4f} ms per call (CUDA events) "
                  f"({card})")
    return out


def synthetic_batch(cfg, dev, B=32, seed=SEED + 20):
    """One training batch from the synthetic dataset, tokenized, with
    seeded t and importance weights of 1, on ``dev``; and seeded noise."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.loader import collate
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)

    ds = SyntheticText2MotionDataset(cfg.data, size=B, seed=seed)
    captions, motions, lengths = collate([ds[i] for i in range(B)])
    rng = np.random.default_rng(seed)
    batch = {"motion": torch.from_numpy(motions),
             "length": torch.from_numpy(lengths).long(),
             "text_ids": torch.from_numpy(hash_tokenize(
                 captions, cfg.model.text_max_tokens)).long(),
             "t": torch.from_numpy(rng.integers(
                 0, cfg.diffusion.num_timesteps, size=B)).long(),
             "t_weight": torch.ones(B)}
    noise = torch.from_numpy(rng.standard_normal(motions.shape).astype(
        np.float32))
    return {k: v.to(dev) for k, v in batch.items()}, noise.to(dev)


def phase_d2(cfg, dev):
    """One f32 train step through the kernels and with use_kernels=False:
    equal losses; every trainable parameter gets a finite gradient through
    the kernels (the autograd Functions carry it); gradients agree."""
    import torch
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", dropout=0.0, stochastic_depth_min=1.0))
    model = build_flagship(cfg32).to(dev)
    state = create_train_state(model, cfg32)
    step = TrainStep(make_schedule(num_timesteps=1000, device=dev), cfg32)
    batch, noise = synthetic_batch(cfg32, dev)
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    runs = {}
    for flag in (True, False):
        model.set_use_kernels(flag)
        metrics = step.backward(state, batch, None, noise=noise)
        torch.cuda.synchronize()
        runs[flag] = (metrics["loss_total"].item(),
                      {n: None if p.grad is None else p.grad.detach().clone()
                       for n, p in trainable})
        state.optimizer.zero_grad()
    model.set_use_kernels(True)
    (lk, gk), (lp, gp) = runs[True], runs[False]
    missing = [n for n, g in gk.items() if g is None
               or not bool(torch.isfinite(g).all())]
    B, T = batch["motion"].shape[:2]
    print(f"[D2] flagship train step f32, B={B} T={T}: {len(trainable)} "
          f"trainable parameters, {len(missing)} without a finite gradient "
          f"through the kernels {missing[:5]}")
    check(not missing, "parameters without a finite gradient through the "
                       "kernels")
    rel = abs(lk - lp) / abs(lp)
    ok = rel <= STEP_LOSS_REL
    print(f"[D2] loss kernels {lk:.8f} vs use_kernels=False {lp:.8f}: rel "
          f"{rel:.3e}; tol {STEP_LOSS_REL:g} -> {'ok' if ok else 'FAIL'}")
    check(ok, "train-step loss kernels vs plain")
    rms_all = torch.sqrt(torch.stack([g.pow(2).mean() for g in gp.values()])
                         .mean()).item()
    rels = {}
    for n in gk:
        rms = gp[n].pow(2).mean().sqrt().item()
        err = (gk[n] - gp[n]).pow(2).mean().sqrt().item()
        rels[n] = err / max(rms, 1e-3 * rms_all)
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    ok = worst[0][1] <= STEP_GRAD_REL_RMS
    print(f"[D2] gradient rel RMS, kernels vs use_kernels=False, worst: "
          + ", ".join(f"{n} {r:.3e}" for n, r in worst)
          + f"; median {np.median(list(rels.values())):.3e}; tol "
          f"{STEP_GRAD_REL_RMS:g} (floor 1e-3 x RMS of all gradients "
          f"{rms_all:.3e}) -> {'ok' if ok else 'FAIL'}")
    check(ok, "train-step gradients kernels vs plain")
    del model, state, runs, gk, gp
    torch.cuda.empty_cache()


def run_train_cli(argv):
    """tools/train.py main(), its stdout kept and echoed; returns (final
    state, stdout, per-step ms)."""
    import torch
    from motiondiffusion_moe_tpu_torch.tools import train as train_cli
    from motiondiffusion_moe_tpu_torch.training import train_state as TS

    times = []
    call = TS.TrainStep.__call__

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, *a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    buf = io.StringIO()
    TS.TrainStep.__call__ = timed
    try:
        with contextlib.redirect_stdout(buf):
            state = train_cli.main(argv)
    finally:
        TS.TrainStep.__call__ = call
        print(buf.getvalue(), end="")
    return state, buf.getvalue(), times


def phase_d3(dev, card):
    """The port's training CLI at the flagship defaults: 4 optimizer steps,
    a checkpoint, a resume; launch counts of the Performer kernels."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import activations as ACT
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    counts = (P.favor_qkv, P.favor_qkv_bwd, P.performer_epilogue,
              P.performer_epilogue_bwd, ACT.activation_grad)
    with tempfile.TemporaryDirectory() as ckdir:
        argv = ["--dataset", "synthetic", "--synthetic_size", "64",
                "--batch_size", "32", "--device", "cuda", "--log_every", "1",
                "--checkpoint_dir", ckdir]
        for c in counts:
            c.launches = 0
        state, out, times = run_train_cli(argv + ["--num_epochs", "1"])
        launches = {c.__name__: c.launches for c in counts}
        losses = [float(v) for v in re.findall(r"loss_total: (\S+)", out)]
        check(state.step == 4, f"trained {state.step} steps, expected 4")
        check(len(losses) == 4 and all(math.isfinite(v) for v in losses),
              f"losses {losses}")
        steps = 4
        n_perf = 2 * 2 * state.model.config.num_layers
        print(f"[D3] 4 optimizer steps, losses (cond, uncond per batch) "
              f"{losses}; launches {launches}; expected favor_qkv and "
              f"favor_qkv_bwd {n_perf} x {steps} = {n_perf * steps}, "
              f"the epilogue and its backward 0 (dropout 0.1), "
              f"activation_grad at least {steps}")
        check(launches["favor_qkv"] == n_perf * steps
              and launches["favor_qkv_bwd"] == n_perf * steps,
              "favor_qkv launch counts")
        check(launches["activation_grad"] >= steps,
              "the activations' gradient pass did not run")
        check(launches["performer_epilogue"] == 0
              and launches["performer_epilogue_bwd"] == 0,
              "the epilogue ran under dropout")
        ckpt = os.path.join(ckdir, "t2m_moe_small", "ckpt")
        check(sorted(os.listdir(ckpt)) == ["step_4.pt"],
              f"checkpoints {os.listdir(ckpt)}")
        del state
        torch.cuda.empty_cache()
        state, out2, times2 = run_train_cli(argv + ["--num_epochs", "2"])
        check("resumed from step 4 (epoch 1)" in out2,
              "second main() did not resume at step 4, epoch 1")
        check(state.step == 8, f"resumed run ended at step {state.step}")
        del state
        torch.cuda.empty_cache()
    steady = times[1:] + times2[1:]
    ms = float(np.median(steady))
    print(f"[D3] resumed at step 4, epoch 1, ran to step 8. ms per optimizer "
          f"step (B=32, bf16 compute, host clock around each synchronised "
          f"step): first {times[0]:.1f} / {times2[0]:.1f}, then "
          f"{', '.join(f'{x:.1f}' for x in steady)}; median {ms:.1f} ms "
          f"({card})")
    return launches, ms


def phase_d4(cfg, dev):
    """Two steps through Trainer at dropout 0: the fused epilogue and its
    backward run in training too."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.loader import DataLoader
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg0 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
        train=dataclasses.replace(cfg.train, num_epochs=1))
    trainer = Trainer(cfg0, device=dev)
    state = trainer.init_state()
    loader = DataLoader(SyntheticText2MotionDataset(cfg0.data, size=32),
                        batch_size=32)
    counts = (P.favor_qkv, P.favor_qkv_bwd, P.performer_epilogue,
              P.performer_epilogue_bwd)
    for c in counts:
        c.launches = 0
    state = trainer.fit(state, loader)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counts}
    n_perf = 2 * 2 * cfg0.model.num_layers
    print(f"[D4] Trainer, dropout 0: {state.step} steps; launches "
          f"{launches}; expected {n_perf} x {state.step} = "
          f"{n_perf * state.step} each")
    check(state.step == 2, f"{state.step} steps, expected 2")
    check(all(v == n_perf * state.step for v in launches.values()),
          "launch counts at dropout 0")
    check(all(bool(torch.isfinite(p).all())
              for p in state.model.parameters()), "non-finite parameters")
    del trainer, state
    torch.cuda.empty_cache()
    return launches


def set_fused_paths(model, on: bool) -> None:
    """This slice's two switches: MOE_FUSED_KERNEL (set to 1, or unset) and
    use_fast_xattn on every exact cross-attention. The Performer kernels
    are left as they are."""
    from motiondiffusion_moe_tpu_torch.models.attention import (
        CrossAttentionBlock)

    if on:
        os.environ["MOE_FUSED_KERNEL"] = "1"
    else:
        os.environ.pop("MOE_FUSED_KERNEL", None)
    for m in model.modules():
        if isinstance(m, CrossAttentionBlock):
            m.use_fast_xattn = on


def kernels_per_call(fn) -> str:
    """The CUDA kernels one call of ``fn`` launches and their summed device
    time, from torch.profiler (a discarded warm-up cycle first, as in
    device_ms); printed only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n:
            us = sum(e.self_device_time_total for e in events)
            return f"{n} kernels, {us / 1e3:.3f} ms of device time"
    return "not measured"


def _top2_combine(rng, S, E):
    """Routing weights as the MoE layer makes them: the top-2 of a softmax
    over E experts per token, zero elsewhere."""
    p = np.exp(rng.standard_normal((S, E)))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, -1, kind="stable")[:, :2]
    combine = np.zeros((S, E), np.float32)
    np.put_along_axis(combine, idx, np.take_along_axis(p, idx, -1), -1)
    return combine


def moe_bound(S, D, E, hid):
    """The fused MoE chain's bound: x, combine, the weights and biases read
    once and out written once in bf16; the two products and combine . b2
    at the bf16 tensor-core rate."""
    return bound(2 * (2 * S * D + S * E + 2 * E * D * hid + E * hid + E * D),
                 4 * S * D * E * hid + 2 * S * E * D, "bf16")


def unfused_moe_chain(x, combine, w1, b1, w2, b2):
    """The expert chain as the MoE layer runs it with MOE_FUSED_KERNEL
    unset (``models/moe.py``): a function of no arguments for timing."""
    from motiondiffusion_moe_tpu_torch.ops.activations import gelu

    S, D = x.shape
    E, _, hid = w1.shape

    def chain():
        w1m = w1.permute(1, 0, 2).reshape(D, E * hid)
        h = gelu(x @ w1m, b1.reshape(E * hid)).view(S, E, hid)
        h = h * combine[:, :, None]
        return h.reshape(S, E * hid) @ w2.reshape(E * hid, D) + combine @ b2

    return chain


def unfused_style_chain(h, scale, shift, ln_scale, ln_bias, w, b):
    """The StylizationBlock body as it runs with ``fused=False`` and no
    dropout (``models/embeddings.py``): LayerNorm, modulation, SiLU, the
    Dense with its bias. A function of no arguments for timing."""
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops.activations import silu
    from motiondiffusion_moe_tpu_torch.ops.performer import LN_EPS

    def chain():
        normed = F.layer_norm(h.float(), (h.shape[-1],), ln_scale, ln_bias,
                              LN_EPS).to(h.dtype)
        return silu(normed * (1 + scale[:, None, :])
                    + shift[:, None, :]) @ w + b

    return chain


def compare_to_plain(tag, name, out, ref, dtype, floor):
    """A kernel's output against its plain version's: f32 to F32_REL of
    the largest value; bf16 to one rounding plus ``floor``. Returns the
    largest absolute error."""
    import torch

    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
    err = (out - ref).abs()
    max_abs, top = err.max().item(), ref.abs().max().item()
    if dtype == torch.float32:
        ok = max_abs <= F32_REL * top
        tol_s = (f"max_abs <= {F32_REL:g} * max|plain| = "
                 f"{F32_REL * top:.3e} (f32 sums in another order)")
    else:
        ok = bool((err <= BF16_REL * ref.abs() + floor).all())
        tol_s = (f"|err| <= 2^-7 |plain| + {floor:.3e} elementwise "
                 "(one bf16 rounding of the same f32 result)")
    print(f"[{tag}] {name}: max_abs_err={max_abs:.3e} (max|plain| "
          f"{top:.3e}); tol {tol_s} -> {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} outside tolerance")
    return max_abs


def bf16_flips(out, ref):
    """(share of the values that differ, largest difference in bf16 ulps):
    the tests' rule, ``tests/_bf16.py``, loaded by its path (an installed
    package named ``tests`` would shadow the repo's directory)."""
    global _BF16_RULE
    if _BF16_RULE is None:
        spec = importlib.util.spec_from_file_location(
            "mdm_bf16_rule", os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "tests", "_bf16.py"))
        _BF16_RULE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_BF16_RULE)
    return _BF16_RULE.bf16_flips(out, ref)


_BF16_RULE = None


def compare_flips(tag, name, out, ref, share):
    """A bf16 kernel against its plain version: at most ``share`` of the
    values one ulp apart, none further. Returns the largest absolute
    error."""
    import torch

    check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
    flipped, worst = bf16_flips(out, ref)
    ok = flipped <= share and worst <= 1.0
    max_abs = (out.float() - ref.float()).abs().max().item()
    print(f"[{tag}] {name}: {flipped:.4%} of the values differ from the "
          f"plain version, by at most {worst:.3g} ulp (max_abs_err "
          f"{max_abs:.3e}, max|plain| {ref.float().abs().max().item():.3e}); "
          f"tol at most {share:.2%} and one ulp -> {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} outside tolerance")
    return max_abs


def grad_vs_plain(tag, name, fn, plain, args, g, wanted=None):
    """Gradients through a wrapper's autograd Function against autograd of
    its plain version, in f32, for the inputs numbered in ``wanted`` (all
    by default)."""
    import torch

    wanted = range(len(args)) if wanted is None else wanted
    xs = [a.detach().float().requires_grad_(i in wanted)
          for i, a in enumerate(args)]
    ys = [a.detach().float().requires_grad_(i in wanted)
          for i, a in enumerate(args)]
    (fn(xs) * g).sum().backward()
    (plain(ys) * g).sum().backward()
    torch.cuda.synchronize()
    worst = max(((xs[i].grad - ys[i].grad).abs().max()
                 / ys[i].grad.abs().max().clamp_min(1e-30)).item()
                for i in wanted)
    ok = worst <= GRAD_REL
    print(f"[{tag}] {name} gradient through the autograd Function vs "
          f"autograd of the plain version, f32: worst max_abs / "
          f"max|grad| {worst:.3e}; tol {GRAD_REL:g} -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} gradient")


def phase_e1(dev, card):
    """The fused-MoE and fast cross-attention kernels against their plain
    versions, with times, bounds, the library yardstick and gradients."""
    import torch
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE

    rng = np.random.default_rng(SEED + 30)
    results = {}

    def t(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    # S = 600 and 6272 end in a ragged token tile; E = 3 is no power of two
    moe_shapes = (("flagship", 6272, 512, 4, 256), ("S=600", 600, 512, 4, 256),
                  ("E=3", 1000, 384, 3, 128),
                  ("moe_big", 6272, 768, 16, 1024))
    for label, S, D, E, hid in moe_shapes:
        base = [t(S, D), torch.from_numpy(_top2_combine(rng, S, E)).to(dev),
                t(E, D, hid, s=D ** -0.5), t(E, hid, s=0.1),
                t(E, hid, D, s=hid ** -0.5), t(E, D, s=0.1)]
        for dtype in (torch.bfloat16, torch.float32):
            args = [a.to(dtype) for a in base]
            name = (f"moe_dense_fused {label} {str(dtype)[6:]} S={S} D={D} "
                    f"E={E} hid={hid}")
            out = MOE.moe_dense_fused(*args)
            torch.cuda.synchronize()
            ref = MOE.moe_dense_fused_plain(*args)
            err = compare_to_plain(
                "E1", name, out, ref, dtype,
                MOE_BF16_FLOOR * ref.float().abs().max().item())
            again = MOE.moe_dense_fused(*args)
            torch.cuda.synchronize()
            check(torch.equal(again, out), f"{name}: a second call gave "
                                           f"other bits")
            # for comparing the bits across checkouts on one card
            # (scripts/kernel_digests.py draws other inputs)
            print(f"[E1] {name}: SHA-256 of the output {digest(out)}")
            if label not in ("flagship", "moe_big") or dtype != torch.bfloat16:
                continue
            kernel = lambda: MOE.moe_dense_fused(*args)  # noqa: E731
            plain = lambda: MOE.moe_dense_fused_plain(*args)  # noqa: E731
            k_ms, p_ms = paired_ms(kernel, plain)
            b_ms, b_by = moe_bound(S, D, E, hid)
            print(f"[E1] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"per call (CUDA events); device time kernel "
                  f"{device_ms(kernel)}, plain {device_ms(plain)} "
                  f"(torch.profiler); bound {b_ms:.4f} ms ({b_by}); the "
                  f"same bits on a second call; no single PyTorch call "
                  f"computes it ({card})")
            if label == "moe_big":
                continue
            chain = unfused_moe_chain(*args)
            c_ms, k2_ms = paired_ms(chain, kernel)
            c_err = (chain().float() - ref.float()).abs().max().item()
            print(f"[E1] {name}: the unfused path's cuBLAS chain "
                  f"(models/moe.py with MOE_FUSED_KERNEL unset: two cuBLAS "
                  f"GEMMs, the gelu kernel, the combine product and "
                  f"combine . b2; several calls, rounding to bf16 between "
                  f"them, {c_err:.3e} from the plain version at most) "
                  f"{c_ms:.4f} ms per call against the kernel's {k2_ms:.4f} "
                  f"in turns (CUDA events); device time chain "
                  f"{device_ms(chain)}, kernel {device_ms(kernel)} "
                  f"(torch.profiler) ({card})")
            # a quarter of the token tiles: a time that stays the same says
            # that each SM's own work, not the card's L2, sets the time
            quarter = lambda: MOE.moe_dense_fused(  # noqa: E731
                args[0][:1584], args[1][:1584], *args[2:])
            print(f"[E1] {name}: the kernel at S=1584 (33 token tiles, a "
                  f"quarter of the SMs busy) {time_ms(quarter):.4f} ms per "
                  f"call (CUDA events), device time {device_ms(quarter)} "
                  f"(torch.profiler) ({card})")
            results["moe_dense_fused"] = (err, k_ms, p_ms, b_ms, b_by, None)
            grad_vs_plain("E1", "moe_dense_fused flagship",
                          lambda a: MOE.moe_dense_fused(*a),
                          lambda a: MOE.moe_dense_fused_plain(*a), args,
                          t(S, D))

    # long N: past what the f32 kernel holds in shared memory (bf16 only)
    xattn_shapes = (("flagship", 32, 196, 85, 4, 128),
                    ("H=8 D=96", 32, 196, 85, 8, 96),
                    ("long N", 8, 196, 1024, 4, 128))
    for label, B, T, N, H, D in xattn_shapes:
        base = [t(B, T, H * D), t(B, N, H * D), t(B, N, H * D)]
        scale = D ** -0.5
        for dtype in ((torch.bfloat16,) if label == "long N"
                      else (torch.bfloat16, torch.float32)):
            q, k, v = (a.to(dtype) for a in base)
            name = (f"xattn_fastlayout {label} {str(dtype)[6:]} B={B} T={T} "
                    f"N={N} H={H} D={D}")
            out = XA.xattn_fastlayout(q, k, v, H, scale)
            torch.cuda.synchronize()
            ref = XA.xattn_fastlayout_plain(q, k, v, H, scale)
            err = (compare_flips("E1", name, out, ref, XATTN_FLIP_SHARE)
                   if dtype == torch.bfloat16 else compare_to_plain(
                       "E1", name, out, ref, dtype, BF16_ABS))
            if label != "flagship" or dtype != torch.bfloat16:
                continue
            kernel = lambda: XA.xattn_fastlayout(  # noqa: E731
                q, k, v, H, scale)
            plain = lambda: XA.xattn_fastlayout_plain(  # noqa: E731
                q, k, v, H, scale)
            heads = [a.view(B, -1, H, D).transpose(1, 2) for a in (q, k, v)]
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *heads, scale=scale)
            k_ms, p_ms = paired_ms(kernel, plain)
            l_ms = time_ms(library)
            lib_out = library().transpose(1, 2).reshape(B, T, H * D)
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            lib_flips, lib_ulps = bf16_flips(lib_out, ref)
            b_ms, b_by, floor_ms = attention_bound(B * H, T, N, D)
            print(f"[E1] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"scaled_dot_product_attention {l_ms:.4f} ms per call "
                  f"(CUDA events; its bf16 probabilities put it "
                  f"{lib_err:.3e} from the plain version at most, "
                  f"{lib_flips:.2%} of the values by up to {lib_ulps:.3g} "
                  f"ulp); device time kernel {device_ms(kernel)}, plain "
                  f"{device_ms(plain)}, library {device_ms(library)} "
                  f"(torch.profiler); bound {b_ms:.4f} ms ({b_by}); the "
                  f"floor of IEEE f32 FMA products (PR 4's design) "
                  f"{floor_ms:.4f} ms ({card})")
            results["xattn_fastlayout"] = (err, k_ms, p_ms, b_ms, b_by, l_ms)
            grad_vs_plain("E1", "xattn_fastlayout flagship",
                          lambda a: XA.xattn_fastlayout(*a, H, scale),
                          lambda a: XA.xattn_fastlayout_plain(*a, H, scale),
                          [q, k, v], t(B, T, H * D))
    return results


def phase_e2(cfg, model, dev):
    """The flagship denoiser with both switches on (and the Performer
    kernels) against both off and use_kernels=False: f32 compute tight,
    bf16 compute each against the f32 result. Returns the bf16-compute
    model, configured with use_fast_xattn, for E3."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE

    args, ids = denoiser_inputs(cfg, dev)
    B, T, F = args[0].shape
    n_moe = 2 * cfg.model.num_layers * cfg.model.moe_num_branches
    n_xattn = 2 * cfg.model.num_layers

    def run(m, on):
        m.set_use_kernels(on)
        set_fused_paths(m, on)
        before = (MOE.moe_dense_fused.launches, XA.xattn_fastlayout.launches)
        with torch.inference_mode():
            out = m(*args, text_ids=ids)
        torch.cuda.synchronize()
        made = (MOE.moe_dense_fused.launches - before[0],
                XA.xattn_fastlayout.launches - before[1])
        check(made == ((n_moe, n_xattn) if on else (0, 0)),
              f"one forward launched (moe, xattn) {made}")
        check(out.shape == (B, T, F) and bool(torch.isfinite(out).all()),
              "denoiser output shape or non-finite")
        return out

    outs = {}
    for dt in ("float32", "bfloat16"):
        m = MotionTransformer(dataclasses.replace(
            cfg.model, dtype=dt, use_fast_xattn=True))
        m.load_state_dict(model.state_dict())
        m.to(dev).eval()
        outs[dt] = (run(m, True), run(m, False))
        if dt == "float32":
            del m
    (k32, ref), (k16, p16) = outs["float32"], outs["bfloat16"]
    rel = rel_rms(k32, ref)
    ok = rel <= DENOISER_F32_REL_RMS
    print(f"[E2] flagship denoiser float32 compute B={B} T={T}, "
          f"use_fast_xattn + MOE_FUSED_KERNEL=1 + the Performer kernels vs "
          f"all off: rel_rms={rel:.3e} max_abs="
          f"{(k32 - ref).abs().max().item():.3e}; {n_moe} moe_dense_fused "
          f"and {n_xattn} xattn_fastlayout launches per forward; tol rel_rms "
          f"<= {DENOISER_F32_REL_RMS:g} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (float32) with both switches vs plain")
    err_k, err_p = rel_rms(k16, ref), rel_rms(p16, ref)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    ok = err_k <= tol
    print(f"[E2] flagship denoiser bfloat16 compute: rel_rms to the f32 "
          f"result: switches and kernels on {err_k:.3e}, all off "
          f"{err_p:.3e}; on vs off {rel_rms(k16, p16):.3e}; tol on <= "
          f"{DENOISER_BF16_FACTOR:g} x off + {DENOISER_BF16_FLOOR:g} = "
          f"{tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (bfloat16) with both switches vs plain")
    m.set_use_kernels(True)
    return m


def phase_e3(cfg, model, dev, card, c_timings):
    """dpm20 through make_server with both switches on: exact launch counts
    of the four kernels of the path; kernels per forward and s/motion with
    the switches off and on."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import activations as ACT
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.serve import make_server

    cfg_fast = dataclasses.replace(cfg, model=model.config)
    pipe = GenerationPipeline(cfg_fast, model, sampler="dpm",
                              num_inference_steps=20, micro_batch=16,
                              param_dtype="bfloat16", device=dev)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    set_fused_paths(pipe.model, True)
    pipe.generate(["warm up"], [T])  # cuBLAS handles, allocator
    counts = (P.favor_qkv, P.performer_epilogue, MOE.moe_dense_fused,
              XA.xattn_fastlayout, ACT.silu, ACT.gelu, ACT.sigmoid)
    prompts = [f"a person performs action number {i}" for i in range(16)]
    srv = make_server(pipe, port=0, max_batch=64)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for c in counts:
            c.launches = 0
        t0 = time.perf_counter()
        status, body = _post(url + "/generate", {
            "texts": prompts, "lengths": [T] * 16, "seed": 11})
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counts}
    finally:
        srv.shutdown()
        srv.server_close()
    check(status == 200, f"E3 request: HTTP {status}")
    motions = [np.asarray(mo, dtype=np.float32) for mo in body["motions"]]
    check([mo.shape for mo in motions] == [(T, F)] * 16
          and all(np.isfinite(mo).all() for mo in motions),
          "E3 motions: shapes or non-finite")
    fwd = pipe.forwards_per_sample  # one micro-batch of 16
    L = cfg.model.num_layers
    per_fwd = {"favor_qkv": 4 * L, "performer_epilogue": 4 * L,
               "moe_dense_fused": 2 * L * cfg.model.moe_num_branches,
               "xattn_fastlayout": 2 * L,
               **activation_launches(cfg.model, moe_fused=True)}
    print(f"[E3] dpm20 request, 16 prompts x {T} frames, both switches on: "
          f"HTTP 200 in {wall:.3f} s (JSON included), batched="
          f"{body['batched']}; {fwd} forwards; launches {launches}; "
          f"expected per forward {per_fwd}")
    for name, n in launches.items():
        check(n == per_fwd[name] * fwd, f"{name} launched {n} times, "
                                        f"expected {per_fwd[name] * fwd}")

    args, ids = denoiser_inputs(cfg, dev)
    seen = {}
    for on in (False, True):
        set_fused_paths(pipe.model, on)

        def forward():
            with torch.inference_mode():
                pipe.model(*args, text_ids=ids)

        seen[on] = kernels_per_call(forward)
    gen = {False: [], True: []}
    for on in (False, True, True, False):
        set_fused_paths(pipe.model, on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.generate(prompts, [T] * 16,
                            generator=torch.Generator(dev).manual_seed(7))
        torch.cuda.synchronize()
        gen[on].append(time.perf_counter() - t0)
        check(all(np.isfinite(o).all() for o in out), "E3 generate")
    set_fused_paths(pipe.model, True)
    print(f"[E3] one denoiser forward (B=32, bf16, torch.profiler): switches "
          f"off {seen[False]}; on {seen[True]}")
    print(f"[E3] dpm20 generate 16 prompts x {T} frames, in turns (off, on, "
          f"on, off): off {', '.join(f'{s:.3f}' for s in gen[False])} s, on "
          f"{', '.join(f'{s:.3f}' for s in gen[True])} s; s/motion off "
          f"{np.mean(gen[False]) / 16:.4f}, on {np.mean(gen[True]) / 16:.4f}"
          f" (phase C dpm20: {c_timings['dpm20'] / 16:.4f}) ({card})")
    return launches


def phase_e4(cfg, dev):
    """Two Trainer steps at dropout 0 with use_fast_xattn: the fast
    cross-attention runs in training (its backward is autograd of the
    plain version), the MoE kernel does not (eval only)."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.loader import DataLoader
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    cfg0 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0,
                                       use_fast_xattn=True),
        train=dataclasses.replace(cfg.train, num_epochs=1))
    os.environ["MOE_FUSED_KERNEL"] = "1"
    trainer = Trainer(cfg0, device=dev)
    state = trainer.init_state()
    loader = DataLoader(SyntheticText2MotionDataset(cfg0.data, size=32),
                        batch_size=32)
    XA.xattn_fastlayout.launches = 0
    MOE.moe_dense_fused.launches = 0
    state = trainer.fit(state, loader)
    torch.cuda.synchronize()
    launches = {"xattn_fastlayout": XA.xattn_fastlayout.launches,
                "moe_dense_fused": MOE.moe_dense_fused.launches}
    os.environ.pop("MOE_FUSED_KERNEL", None)
    n_x = 2 * cfg0.model.num_layers
    trainable = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
    missing = [n for n, p in trainable if p.grad is None
               or not bool(torch.isfinite(p.grad).all())]
    print(f"[E4] Trainer, dropout 0, use_fast_xattn, MOE_FUSED_KERNEL=1: "
          f"{state.step} steps; launches {launches}; expected "
          f"xattn_fastlayout {n_x} x {state.step} = {n_x * state.step}, "
          f"moe_dense_fused 0 (training); {len(trainable)} trainable "
          f"parameters, {len(missing)} without a finite gradient "
          f"{missing[:5]}")
    check(state.step == 2, f"{state.step} steps, expected 2")
    check(launches == {"xattn_fastlayout": n_x * state.step,
                       "moe_dense_fused": 0}, "E4 launch counts")
    check(not missing, "E4 parameters without a finite gradient")
    check(all(bool(torch.isfinite(p).all())
              for p in state.model.parameters()), "non-finite parameters")
    del trainer, state
    torch.cuda.empty_cache()
    return launches


def phase_f1(dev, card):
    """Kernels 7-10 against their plain versions at the flagship shapes
    (f32 and, where the op takes it, bf16), with times, bounds,
    scaled_dot_product_attention as kernel 9's library yardstick, and the
    gradients through each autograd Function. Kernels 9 and 10 are on no
    model's path: each is driven once through its public op at the
    flagship shapes, with its count set to 0 just before."""
    import torch
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(SEED + 40)
    B, T, H, Dh, m, D = 32, 196, 4, 128, 128, 512
    results = {}

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def timed(name, kernel, plain, b, library=None, floor_ms=None):
        """Times and the bound ``b`` = (ms, by) of one kernel; ``floor_ms``
        is its design's own floor, printed beside the bound."""
        k_ms, p_ms = paired_ms(kernel, plain)
        b_ms, b_by = b
        l_ms = time_ms(library) if library is not None else None
        lib_s = (f", scaled_dot_product_attention {l_ms:.4f} ms" if library
                 is not None else "; no single PyTorch call computes it")
        floor_s = ("" if floor_ms is None else f"; the floor of IEEE f32 FMA "
                   f"products (PR 4's design) {floor_ms:.4f} ms")
        if name.startswith("favor"):
            floor_s = (f" (3xTF32 on the tensor cores; "
                       f"{cluster_s(B * H, dev, 2)})"
                       + floor_s.replace("PR 4's design", "PRs 1-5's design"))
        print(f"[F1] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per "
              f"call (CUDA events){lib_s}; device time kernel "
              f"{device_ms(kernel)}, plain {device_ms(plain)}"
              + (f", library {device_ms(library)}" if library is not None
                 else "")
              + f" (torch.profiler); bound {b_ms:.4f} ms ({b_by}){floor_s} "
              f"({card})")
        return k_ms, p_ms, b_ms, b_by, l_ms

    # ---- kernel 7: adaln_dense, a StylizationBlock body at the flagship
    base = [t(B, T, D), t(B, D, s=0.3), t(B, D, s=0.3),
            t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, D, s=D ** -0.5),
            t(D, s=0.1)]
    for dtype in (torch.bfloat16, torch.float32):
        args = [a if i in (3, 4) else a.to(dtype) for i, a in enumerate(base)]
        name = f"adaln_dense {str(dtype)[6:]} B={B} T={T} D=Dout={D}"
        out = AD.adaln_dense(*args)
        torch.cuda.synchronize()
        ref = AD.adaln_dense_plain(*args)
        # bf16: the activations are rounded before the product; a rare
        # one-ulp flip of one moves the output by one ulp of one term
        err = compare_to_plain("F1", name, out, ref, dtype, MOE_BF16_FLOOR
                               * ref.float().abs().max().item())
        if dtype != torch.bfloat16:
            continue
        # h read and out written, scale, shift, w, b in bf16, the LN
        # vectors in f32; the product on the tensor cores
        kernel = lambda: AD.adaln_dense(*args)  # noqa: E731
        numbers = timed(name, kernel, lambda: AD.adaln_dense_plain(*args),
                        bound(2 * (2 * B * T * D + 2 * B * D + D * D + D)
                              + 4 * 2 * D, 2 * B * T * D * D, "bf16"))
        results["adaln_dense"] = (err,) + numbers
        same = torch.equal(kernel(), out)
        print(f"[F1] {name}: a second call gives the same bits: {same}")
        check(same, "adaln_dense differs between two calls")
        chain = unfused_style_chain(*args)
        c_ms, k_ms = paired_ms(chain, kernel)
        c_err = (chain().float() - ref.float()).abs().max().item()
        print(f"[F1] {name}: the unfused StylizationBlock chain "
              f"(fused=False: LayerNorm, modulation, the SiLU kernel and the "
              f"cuBLAS Dense with its bias; several calls, rounding to bf16 "
              f"between them, {c_err:.3e} from the plain version at most) "
              f"{c_ms:.4f} ms per call against the kernel's {k_ms:.4f} in "
              f"turns (CUDA events); device time chain {device_ms(chain)}, "
              f"kernel {device_ms(kernel)} (torch.profiler); bound "
              f"{numbers[2]:.4f} ms ({card})")
    # B*T = 305 rows: three tiles of 96 and a ragged one of 17; Dout = 320
    # takes 64-column slices (slices of the inputs above)
    ragged = [base[0][:5, :61].contiguous(), base[1][:5], base[2][:5],
              base[3], base[4], base[5][:, :320].contiguous(),
              base[6][:320].contiguous()]
    for dtype in (torch.bfloat16, torch.float32):
        args = [a if i in (3, 4) else a.to(dtype)
                for i, a in enumerate(ragged)]
        name = f"adaln_dense {str(dtype)[6:]} B=5 T=61 D={D} Dout=320"
        out = AD.adaln_dense(*args)
        torch.cuda.synchronize()
        ref = AD.adaln_dense_plain(*args)
        compare_to_plain("F1", name, out, ref, dtype, MOE_BF16_FLOOR
                         * ref.float().abs().max().item())
        check(torch.equal(AD.adaln_dense(*args), out),
              f"{name}: a second call gave other bits")
    grad_vs_plain("F1", "adaln_dense", lambda a: AD.adaln_dense(*a),
                  lambda a: AD.adaln_dense_plain(*a), base, t(B, T, D))

    # ---- kernel 8: favor_attention on normalised heads, f32 only
    def unit_rows(x):
        return x / x.norm(dim=-1, keepdim=True)

    q, k, v = unit_rows(t(B, H, T, Dh)), unit_rows(t(B, H, T, Dh)), t(
        B, H, T, Dh)
    proj = t(Dh, m, s=Dh ** -0.25)
    mask = ragged_mask(rng, B, T, dev)
    hmask = mask[:, None, :].contiguous()
    name = f"favor_attention float32 B={B} H={H} T={T} D=m={Dh}"
    out = P.favor_attention(q, k, v, proj, hmask)
    torch.cuda.synchronize()
    ref = P.favor_attention_plain(q, k, v, proj, hmask)
    # a masked frame's denominator is the eps floor (the reference's
    # same-position quirk), so its row is ~1e5 larger: each kind of row is
    # held to its own scale
    valid = (hmask[:, :, :, None] > 0).expand(B, H, T, Dh)
    err = max(compare_to_plain("F1", f"{name}, {kind} frames", out[sel],
                               ref[sel], torch.float32, 0.0)
              for kind, sel in (("valid", valid), ("masked", ~valid)))
    # q, k, v read and out written in f32; the four [T, D] x [D, m]-sized
    # products of every (b, h) in f32
    b_ms, b_by, floor_ms = favor_bound(
        4 * (4 * B * H * T * Dh + Dh * m + B * T), 4 * 2 * B * H * T * Dh * m)
    numbers = timed(name, lambda: P.favor_attention(q, k, v, proj, hmask),
                    lambda: P.favor_attention_plain(q, k, v, proj, hmask),
                    (b_ms, b_by), floor_ms=floor_ms)
    results["favor_attention"] = (err,) + numbers
    grad_vs_plain("F1", "favor_attention", lambda a: P.favor_attention(*a),
                  lambda a: P.favor_attention_plain(*a),
                  [q, k, v, proj, hmask], t(B, H, T, Dh), wanted=(0, 1, 2))

    # ---- kernel 10: favor_attention_full on separate q, k, v
    qkv32 = t(B, T, 3 * H * Dh)
    scale, bias = t(Dh, s=0.1, off=1.0), t(Dh, s=0.1)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = qkv32.to(dtype)
        q3, k3, v3 = (x.contiguous() for x in qkv.split(H * Dh, dim=-1))
        name = f"favor_attention_full {str(dtype)[6:]} B={B} T={T} H={H}"
        out = P.favor_attention_full(q3, k3, v3, scale, bias, proj, mask)
        torch.cuda.synchronize()
        err = compare_to_plain("F1", name, out, P.favor_full_plain(
            q3, k3, v3, scale, bias, proj, mask), dtype, BF16_ABS)
        same = torch.equal(out, P.favor_qkv(qkv, scale, bias, proj, mask))
        print(f"[F1] {name}: bit for bit kernel 1's output on the same "
              f"q, k, v merged into one panel: {same}")
        check(same, "favor_attention_full differs from favor_qkv")
        if dtype != torch.bfloat16:
            continue
        el = qkv.element_size()
        b_ms, b_by, floor_ms = favor_bound(
            B * T * 4 * H * Dh * el + (2 * Dh + Dh * m + B * T) * 4,
            4 * 2 * B * H * T * Dh * m)
        numbers = timed(
            name, lambda: P.favor_attention_full(q3, k3, v3, scale, bias,
                                                 proj, mask),
            lambda: P.favor_full_plain(q3, k3, v3, scale, bias, proj, mask),
            (b_ms, b_by), floor_ms=floor_ms)
        results["favor_attention_full"] = (err,) + numbers
        P.favor_attention_full.launches = 0
        P.favor_attention_full(q3, k3, v3, scale, bias, proj, mask)
        torch.cuda.synchronize()
        results["favor_attention_full_launches"] = (
            P.favor_attention_full.launches)
    grad_vs_plain("F1", "favor_attention_full",
                  lambda a: P.favor_attention_full(*a),
                  lambda a: P.favor_full_plain(*a),
                  [q3, k3, v3, scale, bias, proj, mask], t(B, T, H * Dh),
                  wanted=range(5))

    # ---- kernel 9: flash_cross_attention, head-major, any N
    shapes = (("flagship", B, T, 85), ("long N", B, T, 1024),
              ("T=100, not a multiple of the 32-row tile", 8, 100, 85))
    for label, Bx, Tx, N in shapes:
        base = [t(Bx, H, Tx, Dh), t(Bx, H, N, Dh), t(Bx, H, N, Dh)]
        for dtype in (torch.bfloat16, torch.float32):
            q9, k9, v9 = (a.to(dtype) for a in base)
            name = (f"flash_cross_attention {label} {str(dtype)[6:]} "
                    f"B={Bx} H={H} T={Tx} N={N} D={Dh}")
            out = XA.flash_cross_attention(q9, k9, v9)
            torch.cuda.synchronize()
            ref = XA.flash_cross_attention_plain(q9, k9, v9)
            err = (compare_flips("F1", name, out, ref, XATTN_FLIP_SHARE)
                   if dtype == torch.bfloat16 else compare_to_plain(
                       "F1", name, out, ref, dtype, BF16_ABS))
            if label != "flagship" or dtype != torch.bfloat16:
                continue
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q9, k9, v9)
            lib_err = (library().float() - ref.float()).abs().max().item()
            lib_flips, lib_ulps = bf16_flips(library(), ref)
            print(f"[F1] {name}: scaled_dot_product_attention is "
                  f"{lib_err:.3e} from the plain version at most, "
                  f"{lib_flips:.2%} of the values by up to {lib_ulps:.3g} ulp "
                  f"(bf16 probabilities)")
            b_ms, b_by, floor_ms = attention_bound(Bx * H, Tx, N, Dh)
            numbers = timed(name, lambda: XA.flash_cross_attention(
                q9, k9, v9), lambda: XA.flash_cross_attention_plain(
                q9, k9, v9), (b_ms, b_by), library, floor_ms)
            results["flash_cross_attention"] = (err,) + numbers
            XA.flash_cross_attention.launches = 0
            XA.flash_cross_attention(q9, k9, v9)
            torch.cuda.synchronize()
            results["flash_cross_attention_launches"] = (
                XA.flash_cross_attention.launches)
            grad_vs_plain("F1", "flash_cross_attention",
                          lambda a: XA.flash_cross_attention(*a),
                          lambda a: XA.flash_cross_attention_plain(*a),
                          [q9, k9, v9], t(Bx, H, Tx, Dh))
    return results


def _unfused_forms(model) -> None:
    """Every StylizationBlock fused and every PerformerSelfAttention
    replaced by its unfused twin with the same parameters."""
    from motiondiffusion_moe_tpu_torch.models.bridge import unfuse_performers
    from motiondiffusion_moe_tpu_torch.models.embeddings import (
        StylizationBlock)

    unfuse_performers(model)
    for mod in model.modules():
        if isinstance(mod, StylizationBlock):
            mod.fused = True


def phase_f2(dev):
    """The two module forms at the flagship width (latent 512, 4 heads of
    128, 128 features, time embedding 2048), in f32: each against the form
    it replaces, and one backward through an unfused Performer."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention)
    from motiondiffusion_moe_tpu_torch.models.embeddings import (
        StylizationBlock)
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(SEED + 50)
    B, T, D, H, m, ted = 32, 196, 512, 4, 128, 2048

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    x, emb, g = t(B, T, D), t(B, D), t(B, T, D)
    mask = ragged_mask(rng, B, T, dev)

    def report(name, out, ref, launched):
        rel = rel_rms(out, ref)
        ok = rel <= MODULE_F32_REL_RMS and launched
        print(f"[F2] {name}, float32 B={B} T={T} D={D}: rel_rms="
              f"{rel:.3e}; tol {MODULE_F32_REL_RMS:g}; kernels launched: "
              f"{launched} -> {'ok' if ok else 'FAIL'}")
        check(ok, name)

    block = init_weights(StylizationBlock(D, ted, D), SEED).to(dev).eval()
    with torch.no_grad():
        block.out_kernel.normal_(0.0, 0.02)  # zero-init: perturbed
        ref = block(x, emb)
        block.fused = True
        n0 = AD.adaln_dense.launches
        out = block(x, emb)
    report("StylizationBlock(fused=True) vs fused=False", out, ref,
           AD.adaln_dense.launches == n0 + 1)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = PerformerSelfAttention(D, H, ted, m)

    holder = init_weights(Holder(), SEED).to(dev).eval()
    with torch.no_grad():
        fused = holder.attn(x, emb, mask)
        _unfused_forms(holder)
        n0 = (P.favor_attention.launches, P.performer_epilogue.launches)
        unfused = holder.attn(x, emb, mask)
        made = (P.favor_attention.launches - n0[0],
                P.performer_epilogue.launches - n0[1])
        holder.attn.fast_attention.use_pallas = False
        plain = holder.attn(x, emb, mask)
        holder.attn.fast_attention.use_pallas = True
    report("PerformerSelfAttention(fused=False, grafted by "
           "models/bridge.py) vs the fused form", unfused, fused,
           made == (1, 1))
    report("PerformerSelfAttention(fused=False): FastAttention use_pallas "
           "on vs off", unfused, plain, True)

    n0 = P.favor_attention.launches
    (holder.attn(x, emb, mask) * g).sum().backward()
    torch.cuda.synchronize()
    trainable = [(n, p) for n, p in holder.attn.named_parameters()
                 if p.requires_grad]
    missing = [n for n, p in trainable if p.grad is None
               or not bool(torch.isfinite(p.grad).all())]
    print(f"[F2] one backward through the unfused Performer "
          f"({P.favor_attention.launches - n0} favor_attention launch): "
          f"{len(trainable)} trainable parameters, {len(missing)} without a "
          f"finite gradient {missing[:5]}")
    check(not missing, "unfused Performer: parameters without a gradient")
    del block, holder
    torch.cuda.empty_cache()


def phase_f3(cfg, model, dev, card):
    """The flagship denoiser with every style block fused and every
    Performer unfused (grafted from the same weights): one forward at
    B = 32 through kernels 2, 7 and 8 with exact launch counts, held
    against the standard flagship and against itself on the plain paths,
    in f32; then in bf16 compute, each path against the f32 result."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    args, ids = denoiser_inputs(cfg, dev)
    B, T, F = args[0].shape
    L = cfg.model.num_layers
    expect = {"adaln_dense": 4 * L, "favor_attention": 4 * L,
              "performer_epilogue": 4 * L, "favor_qkv": 0}
    counts = (AD.adaln_dense, P.favor_attention, P.performer_epilogue,
              P.favor_qkv)

    def forward(m):
        with torch.inference_mode():
            out = m(*args, text_ids=ids)
        torch.cuda.synchronize()
        check(out.shape == (B, T, F) and bool(torch.isfinite(out).all()),
              "F3 denoiser output shape or non-finite")
        return out

    outs, seen = {}, {}
    for dt in ("float32", "bfloat16"):
        m = MotionTransformer(dataclasses.replace(cfg.model, dtype=dt))
        m.load_state_dict(model.state_dict())
        m.to(dev).eval()
        if dt == "float32":
            std = forward(m)
        seen[("standard", dt)] = kernels_per_call(lambda: forward(m))
        _unfused_forms(m)
        for c in counts:
            c.launches = 0
        out = forward(m)
        launches = {c.__name__: c.launches for c in counts}
        if dt == "float32":
            main_launches = launches
        seen[("forms", dt)] = kernels_per_call(lambda: forward(m))
        m.set_use_kernels(False)
        outs[dt] = (out, forward(m))
        del m
        torch.cuda.empty_cache()
        print(f"[F3] {dt} compute, every style block fused, every Performer "
              f"unfused: launches in one forward {launches}; expected "
              f"{expect}")
        check(launches == expect, "F3 launch counts")
    (k32, p32), (k16, p16) = outs["float32"], outs["bfloat16"]
    rel_std, rel_plain = rel_rms(k32, std), rel_rms(k32, p32)
    ok = rel_std <= DENOISER_F32_REL_RMS and rel_plain <= FORMS_F32_REL_RMS
    print(f"[F3] flagship denoiser float32 compute B={B} T={T}, the module "
          f"forms through the kernels: vs the standard flagship (same "
          f"weights) rel_rms={rel_std:.3e} (tol {DENOISER_F32_REL_RMS:g}); "
          f"vs use_pallas=False and use_kernels=False rel_rms="
          f"{rel_plain:.3e} (tol {FORMS_F32_REL_RMS:g}) -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "F3 float32 denoiser")
    err_k, err_p = rel_rms(k16, k32), rel_rms(p16, k32)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    ok = err_k <= tol
    print(f"[F3] bfloat16 compute: rel_rms to the f32 result: kernels "
          f"{err_k:.3e}, use_pallas=False and use_kernels=False {err_p:.3e};"
          f" tol kernels <= {DENOISER_BF16_FACTOR:g} x plain + "
          f"{DENOISER_BF16_FLOOR:g} = {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "F3 bfloat16 denoiser")
    for dt in ("float32", "bfloat16"):
        print(f"[F3] one forward (B={B}, {dt} compute, torch.profiler): "
              f"standard flagship {seen[('standard', dt)]}; module forms "
              f"{seen[('forms', dt)]} ({card})")
    return main_launches


def phase_g1(cfg, model, dev, card):
    """A JAX-format export of the flagship served at full width: the
    port's export_model in bf16, the serve CLI's build_server on it, the
    requests of phase C, the seeded motion bit for bit against the
    in-memory bf16 pipeline, kernels 1 and 2 launched exactly 32 x
    forwards; export write / read rates and the latency of 8 sequential
    single-prompt requests."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.export import (
        export_model, load_export)
    from motiondiffusion_moe_tpu_torch.tools.serve import build_server

    os.environ.pop("MOE_FUSED_KERNEL", None)
    T = cfg.model.max_frames
    with tempfile.TemporaryDirectory() as d:
        t_write = []
        for _ in range(2):  # the second into memory the first freed
            t0 = time.perf_counter()
            export_model(model, cfg, d, dtype="bfloat16",
                         normalizer=MotionNormalizer.identity(
                             cfg.data.dim_pose))
            t_write.append(time.perf_counter() - t0)
        size = os.path.getsize(os.path.join(d, "params.msgpack"))
        t0 = time.perf_counter()
        _, tree, _ = load_export(d)
        t_read = time.perf_counter() - t0
        del tree
        print(f"[G1] export of the flagship, bf16 storage: params.msgpack "
              f"{size / 1e9:.3f} GB; write {t_write[0]:.2f} s "
              f"({size / t_write[0] / 1e9:.3f} GB/s), again "
              f"{t_write[1]:.2f} s ({size / t_write[1] / 1e9:.3f} GB/s); "
              f"read {t_read:.2f} s ({size / t_read / 1e9:.3f} GB/s) (host; "
              f"{card})")
        t0 = time.perf_counter()
        srv = build_server(["--export_dir", d, "--sampler", "dpm", "--steps",
                            "20", "--micro_batch", "16", "--port", "0"])
        print(f"[G1] build_server from the export onto the card: "
              f"{time.perf_counter() - t0:.2f} s ({card})")
    pipe = srv.pipe
    check(pipe.device.type == "cuda", f"served on {pipe.device}")
    dtypes = {n: p.dtype for n, p in pipe.model.named_parameters()}
    check(all((dt == torch.float32) == ("projection" in n)
              for n, dt in dtypes.items()), "served storage dtypes")
    samples = []
    sample = pipe.sample

    def counted_sample(*a, **k):
        samples.append(1)
        return sample(*a, **k)

    pipe.sample = counted_sample
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    seeded = {"texts": ["a person bows", "a person climbs stairs"],
              "lengths": [150, 196], "seed": 1234, "denormalize": False}
    try:
        for c in (P.favor_qkv, P.performer_epilogue):
            c.launches = 0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health.get("ok") is True and health.get("device") == "cuda",
              f"/healthz {health}")
        results = {}

        def post_into(key, payload):
            results[key] = _post(url + "/generate", payload)

        first = threading.Thread(target=post_into, args=(
            "a", {"texts": ["a person runs in a circle"] * 4,
                  "lengths": [T] * 4}))
        first.start()
        time.sleep(0.05)
        pair = [threading.Thread(target=post_into, args=(k, {
            "texts": [txt], "lengths": [n]})) for k, txt, n in (
                ("b", "a person waves with the left hand", 120),
                ("c", "a person jumps twice", 64))]
        for t2 in pair:
            t2.start()
        for t2 in [first] + pair:
            t2.join(timeout=600)
            check(not t2.is_alive(), "request thread hung")
        post_into("s1", seeded)
        post_into("s2", seeded)
        F = cfg.model.input_feats
        for key, lens in {"a": [T] * 4, "b": [120], "c": [64],
                          "s1": [150, 196], "s2": [150, 196]}.items():
            status, body = results[key]
            motions = [np.asarray(m, dtype=np.float32)
                       for m in body["motions"]]
            check(status == 200 and [list(m.shape) for m in motions]
                  == [[n, F] for n in lens], f"G1 request {key}")
            check(all(np.isfinite(m).all() for m in motions),
                  f"G1 request {key}: non-finite motion")
        check(results["b"][1]["batched"] == 2
              and results["c"][1]["batched"] == 2,
              "G1: the batcher did not merge the two concurrent requests")
        check(results["s1"][1]["motions"] == results["s2"][1]["motions"],
              "G1: seeded repeats differ")
        fwd = len(samples) * pipe.forwards_per_sample
        launches = {c.__name__: c.launches
                    for c in (P.favor_qkv, P.performer_epilogue)}
        n_perf = 2 * 2 * cfg.model.num_layers
        print(f"[G1] /healthz ok; concurrent seedless requests merged; "
              f"seeded repeats identical; {len(samples)} samples x "
              f"{pipe.forwards_per_sample} forwards = {fwd} forwards; "
              f"launches {launches}, expected {n_perf} x {fwd} each")
        for name, n in launches.items():
            check(n == n_perf * fwd, f"G1: {name} launched {n} times, "
                                     f"expected {n_perf * fwd}")
        lat = []
        for i in range(8):
            t0 = time.perf_counter()
            status, body = _post(url + "/generate", {
                "texts": [f"a person walks in a line {i}"],
                "lengths": [T]})
            lat.append(time.perf_counter() - t0)
            check(status == 200 and body["shapes"] == [[T, F]],
                  "G1 latency request")
        p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
        print(f"[G1] 8 sequential single-prompt requests at {T} frames "
              f"(dpm20, micro_batch 16): p50 {p50:.1f} ms, p99 {p99:.1f} "
              f"ms, each "
              f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms ({card})")
    finally:
        srv.shutdown()
        srv.server_close()
    pipe.sample = sample
    served = [np.asarray(m, dtype=np.float32)
              for m in results["s1"][1]["motions"]]
    del srv, pipe
    ref = GenerationPipeline(cfg, model, sampler="dpm",
                             num_inference_steps=20, micro_batch=16,
                             param_dtype="bfloat16", device=dev)
    want = ref.generate(seeded["texts"], seeded["lengths"],
                        generator=torch.Generator(dev).manual_seed(
                            seeded["seed"]))
    same = all(np.array_equal(a, b) for a, b in zip(served, want))
    print(f"[G1] the served seeded motions vs GenerationPipeline(model, "
          f"param_dtype='bfloat16') from the in-memory model, same seed: "
          f"{'bit-identical' if same else 'DIFFER'} (max abs "
          f"{max(float(np.abs(a - b).max()) for a, b in zip(served, want)):.3e})")
    check(same, "G1: the served motion is not the in-memory pipeline's")
    del ref
    torch.cuda.empty_cache()


def g2_xattn_head_dim_256(card, t, B, T, N, H, hd):
    """Kernels 6 (xattn_fastlayout, [B, T, H*D]) and 9
    (flash_cross_attention, [B, H, T, D]) at head dim 256 against their
    plain versions: bf16 by E1's rule, f32 to F32_REL; ms per call, device
    ms, the bound and scaled_dot_product_attention's time beside them.
    Returns {(kernel, dtype): (err, ms, plain ms, bound ms, by, SDPA ms)}."""
    import torch
    import torch.nn.functional as F
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA

    scale = hd ** -0.5
    b_ms, b_by, floor_ms = attention_bound(B * H, T, N, hd)
    out_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        q, k, v = (t(B, n, H * hd).to(dtype) for n in (T, N, N))
        heads = [a.view(B, -1, H, hd).transpose(1, 2).contiguous()
                 for a in (q, k, v)]
        cases = (
            ("xattn_fastlayout",
             lambda: XA.xattn_fastlayout(q, k, v, H, scale),
             lambda: XA.xattn_fastlayout_plain(q, k, v, H, scale)),
            ("flash_cross_attention",
             lambda: XA.flash_cross_attention(*heads, scale=scale),
             lambda: XA.flash_cross_attention_plain(*heads, scale=scale)))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            *heads, scale=scale)
        for kname, kernel, plain in cases:
            name = f"{kname} {dt} B={B} T={T} N={N} H={H} D={hd}"
            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (compare_flips("G2a", name, out, ref, XATTN_FLIP_SHARE)
                   if dtype == torch.bfloat16 else compare_to_plain(
                       "G2a", name, out, ref, dtype, BF16_ABS))
            k_ms, p_ms = paired_ms(kernel, plain, iters=10)
            l_ms = time_ms(library, 10)
            print(f"[G2a] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, scaled_dot_product_attention {l_ms:.4f} ms per call "
                  f"(CUDA events); device time kernel {device_ms(kernel)}, "
                  f"library {device_ms(library)} (torch.profiler); bound "
                  f"{b_ms:.4f} ms ({b_by}); the floor of IEEE f32 FMA "
                  f"products {floor_ms:.4f} ms ({card})")
            out_rows[(kname, dtype)] = (err, k_ms, p_ms, b_ms, b_by, l_ms)
    return out_rows


def phase_g2(dev, card):
    """tools/train.py --model_size big on the card (latent 1024, head dim
    256, expert hidden 512; depth cut to 2 blocks per scale), the widths of
    the kernel instances added for it. G2a: kernels 1-5 and 7 against their
    plain versions at the shapes this path gives them (B = 4, T = 196,
    ragged mask), bf16 and f32, with times and bounds. G2b: the forward
    through the kernels with MOE_FUSED_KERNEL=1 against use_kernels=False
    with the switch unset, in f32 (tight) and bf16 (phase B's rule), with
    exact launch counts of kernels 1, 2 and 5. G2c: two train steps through
    the train CLI, through kernels 1 and 3. The flagship's modules are
    untouched by any of it."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.attention import (
        PerformerSelfAttention)
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.ops import adaln as AD
    from motiondiffusion_moe_tpu_torch.ops import moe as MOE
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.tools.train import (
        build_argparser, config_from_args)

    argv = ["--dataset", "synthetic", "--model_size", "big", "--num_layers",
            "2"]
    big = config_from_args(build_argparser().parse_args(argv))
    mc = big.model
    B, T, D, H = 4, mc.max_frames, mc.latent_dim, mc.num_heads
    hd, m, E, hid = D // H, mc.num_random_features, mc.num_experts, mc.ff_size
    check((D, hd, m, hid) == (1024, 256, 128, 512), "G2 widths")
    print(f"[G2] --model_size big: latent {D}, {H} heads of {hd}, {m} random "
          f"features, {E} experts of hidden {hid}, 2 blocks per scale")

    # ---- G2a: the kernels at these widths against their plain versions
    rng = np.random.default_rng(SEED + 60)

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def timed(name, kernel, plain, nbytes, flops, kind):
        k_ms, p_ms = paired_ms(kernel, plain, iters=10)
        b_ms, b_by = bound(nbytes, flops, kind)
        print(f"[G2a] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms per "
              f"call (CUDA events); bound {b_ms:.4f} ms ({b_by}) ({card})")

    mask = ragged_mask(rng, B, T, dev)
    ln_s, ln_b, proj = t(hd, s=0.1, off=1.0), t(hd, s=0.1), t(
        hd, m, s=hd ** -0.25)
    for dtype in (torch.bfloat16, torch.float32):
        dt, el = str(dtype)[6:], 2 if dtype == torch.bfloat16 else 4
        qkv = t(B, T, 3 * H * hd).to(dtype)
        name = f"favor_qkv {dt} B={B} T={T} H={H} D={hd} m={m}"
        out = P.favor_qkv(qkv, ln_s, ln_b, proj, mask)
        torch.cuda.synchronize()
        compare_to_plain("G2a", name, out,
                         P.favor_qkv_plain(qkv, ln_s, ln_b, proj, mask),
                         dtype, BF16_ABS)
        check(torch.equal(out, P.favor_qkv(qkv, ln_s, ln_b, proj, mask)),
              f"{name}: a second call gave other bits")
        timed(name, lambda: P.favor_qkv(qkv, ln_s, ln_b, proj, mask),
              lambda: P.favor_qkv_plain(qkv, ln_s, ln_b, proj, mask),
              B * T * 4 * H * hd * el + (2 * hd + hd * m + B * T) * 4,
              3 * 4 * 2 * B * H * T * hd * m, "tf32")
        g = t(B, T, H * hd).to(dtype)
        for need in (False, True):
            name = (f"favor_qkv_bwd {dt} B={B} T={T} D={hd} d(proj)="
                    f"{'yes' if need else 'no'}")
            outs = P.favor_qkv_bwd(qkv, ln_s, ln_b, proj, mask, g,
                                   need_dproj=need)
            torch.cuda.synchronize()
            refs = P.favor_qkv_bwd_plain(qkv, ln_s, ln_b, proj, mask, g,
                                         need_dproj=need)
            for i, (o, r) in enumerate(zip(outs, refs)):
                if r is None:
                    check(o is None, f"{name} output {i} should be None")
                    continue
                o, r = o.float(), r.float()
                err = (o - r).abs()
                floor = BWD_FLOOR * r.abs().max().item()
                ok = bool(torch.isfinite(o).all()) and (
                    err.max().item() <= floor
                    if i or dtype == torch.float32 else
                    bool((err <= 2 ** -7 * r.abs() + floor).all()))
                print(f"[G2a] {name} output {i}: max_abs_err="
                      f"{err.max().item():.3e} (max|plain| "
                      f"{r.abs().max().item():.3e}); tol f32 {BWD_FLOOR:g} "
                      f"max|plain|, bf16 + 2^-7 |plain| -> "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{name} output {i} outside tolerance")
            if not need:
                timed(name, lambda: P.favor_qkv_bwd(
                          qkv, ln_s, ln_b, proj, mask, g, need_dproj=False),
                      lambda: P.favor_qkv_bwd_plain(
                          qkv, ln_s, ln_b, proj, mask, g, need_dproj=False),
                      B * T * 7 * H * hd * el + (4 * hd + hd * m + B * T) * 4,
                      3 * 10 * 2 * B * H * T * hd * m, "tf32")
        # kernel 2 on the style block's strided chunk views, and its
        # backward on contiguous scale and shift, as the Function passes them
        y = t(B, T, D).to(dtype)
        sc, sh = t(B, 2 * D, s=0.3).to(dtype).chunk(2, dim=-1)
        vecs = [t(D, s=0.1, off=1.0), t(D, s=0.1), t(D, s=0.1, off=1.0),
                t(D, s=0.1)]
        name = f"performer_epilogue {dt} B={B} T={T} D={D}"
        out = P.performer_epilogue(y, sc, sh, *vecs)
        torch.cuda.synchronize()
        compare_to_plain("G2a", name, out,
                         P.performer_epilogue_plain(y, sc, sh, *vecs), dtype,
                         BF16_ABS)
        timed(name, lambda: P.performer_epilogue(y, sc, sh, *vecs),
              lambda: P.performer_epilogue_plain(y, sc, sh, *vecs),
              2 * B * T * D * el + 2 * B * D * el + 4 * D * 4,
              17 * B * T * D, "f32")
        sc, sh = sc.contiguous(), sh.contiguous()
        name = f"performer_epilogue_bwd {dt} B={B} T={T} D={D}"
        outs = P.performer_epilogue_bwd(y, sc, sh, *vecs, g.view(B, T, D))
        torch.cuda.synchronize()
        refs = P.performer_epilogue_bwd_plain(y, sc, sh, *vecs,
                                              g.view(B, T, D))
        for i, (o, r) in enumerate(zip(outs, refs)):
            o, r = o.float(), r.float()
            err = (o - r).abs()
            floor = BWD_FLOOR * r.abs().max().item()
            ok = bool(torch.isfinite(o).all()) and (
                err.max().item() <= floor if i > 2 or dtype == torch.float32
                else bool((err <= 2 ** -7 * r.abs() + floor).all()))
            print(f"[G2a] {name} output {i}: max_abs_err="
                  f"{err.max().item():.3e} (max|plain| "
                  f"{r.abs().max().item():.3e}) -> {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} output {i} outside tolerance")
        timed(name, lambda: P.performer_epilogue_bwd(y, sc, sh, *vecs,
                                                     g.view(B, T, D)),
              lambda: P.performer_epilogue_bwd_plain(y, sc, sh, *vecs,
                                                     g.view(B, T, D)),
              3 * B * T * D * el + 4 * B * D * el + 8 * D * 4,
              50 * B * T * D, "f32")
        # kernel 5 on the tokens of this batch, kernel 7 on a style block
        S = B * T
        args = [t(S, D), torch.from_numpy(_top2_combine(rng, S, E)).to(dev),
                t(E, D, hid, s=D ** -0.5), t(E, hid, s=0.1),
                t(E, hid, D, s=hid ** -0.5), t(E, D, s=0.1)]
        args = [a.to(dtype) for a in args]
        name = f"moe_dense_fused {dt} S={S} D={D} E={E} hid={hid}"
        out = MOE.moe_dense_fused(*args)
        torch.cuda.synchronize()
        ref = MOE.moe_dense_fused_plain(*args)
        compare_to_plain("G2a", name, out, ref, dtype,
                         MOE_BF16_FLOOR * ref.float().abs().max().item())
        check(torch.equal(out, MOE.moe_dense_fused(*args)),
              f"{name}: a second call gave other bits")
        timed(name, lambda: MOE.moe_dense_fused(*args),
              lambda: MOE.moe_dense_fused_plain(*args),
              el * (2 * S * D + S * E + 2 * E * D * hid + E * hid + E * D),
              4 * S * D * E * hid + 2 * S * E * D,
              "bf16" if dtype == torch.bfloat16 else "f32")
        args = [y, t(B, D, s=0.3), t(B, D, s=0.3), t(D, s=0.1, off=1.0),
                t(D, s=0.1), t(D, D, s=D ** -0.5), t(D, s=0.1)]
        args = [a if i in (3, 4) else a.to(dtype) for i, a in enumerate(args)]
        name = f"adaln_dense {dt} B={B} T={T} D=Dout={D}"
        out = AD.adaln_dense(*args)
        torch.cuda.synchronize()
        ref = AD.adaln_dense_plain(*args)
        compare_to_plain("G2a", name, out, ref, dtype,
                         MOE_BF16_FLOOR * ref.float().abs().max().item())
        timed(name, lambda: AD.adaln_dense(*args),
              lambda: AD.adaln_dense_plain(*args),
              el * (2 * B * T * D + 2 * B * D + D * D + D) + 8 * D,
              2 * B * T * D * D, "bf16" if dtype == torch.bfloat16 else "f32")
    # kernels 6 and 9 at head dim 256 (use_fast_xattn at these widths), on
    # the text encoder's N keys
    N = mc.text_max_tokens + mc.text_num_prompt_tokens
    g2_xattn_head_dim_256(card, t, B, T, N, H, hd)
    from motiondiffusion_moe_tpu_torch.ops import _build

    for kname in ("favor_kernel", "favor_qkv_bwd_kernel",
                  "performer_epilogue_kernel",
                  "performer_epilogue_bwd_kernel", "moe_bf16_kernel",
                  "moe_f32_kernel", "adaln_bf16_kernel", "adaln_f32_kernel",
                  "cross_attention_mma_kernel", "xattn_fastlayout_kernel",
                  "flash_xattn_kernel"):
        for line in _build.resource_usage(kname):
            if any(f"Li{v}E" in line for v in (256, 1024, 32)):
                print(f"[G2a] ptxas: {line}")
    # the bf16 tensor-core instance at head dim 256 holds a 16-row tile a
    # warp so that its accumulator stays in registers: no spill
    usage = [u for u in _build.resource_usage("cross_attention_mma_kernel")
             if "Li256E" in u]
    if not usage:
        print("[G2a] ptxas: not reported (the library came from the cache)")
    check(all(" 0 bytes spill stores" in u for u in usage),
          "cross_attention_mma_kernel spills at D = 256")

    # ---- G2b: the forward through the kernels
    mb = build_flagship(big).to(dev).eval()
    n_perf = sum(isinstance(x, PerformerSelfAttention) for x in mb.modules())
    n_moe = sum(isinstance(x, SwitchMoELayer) for x in mb.modules())
    args, ids = denoiser_inputs(big, dev, B=B)
    m32 = MotionTransformer(dataclasses.replace(mc, dtype="float32"))
    m32.load_state_dict(mb.state_dict())
    m32.to(dev).eval()
    counted = (P.favor_qkv, P.performer_epilogue, MOE.moe_dense_fused)
    with torch.inference_mode():
        m32.set_use_kernels(False)  # MOE_FUSED_KERNEL unset here
        ref = m32(*args, text_ids=ids)
        mb.set_use_kernels(False)
        p16 = mb(*args, text_ids=ids)
        mb.set_use_kernels(True)
        m32.set_use_kernels(True)
        for c in counted:
            c.launches = 0
        os.environ["MOE_FUSED_KERNEL"] = "1"
        try:
            k32 = m32(*args, text_ids=ids)
            k16 = mb(*args, text_ids=ids)
        finally:
            os.environ.pop("MOE_FUSED_KERNEL", None)
        torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counted}
    want = {"favor_qkv": 2 * n_perf, "performer_epilogue": 2 * n_perf,
            "moe_dense_fused": 2 * n_moe}
    for out in (ref, k32, k16, p16):
        check(bool(torch.isfinite(out).all()), "G2 non-finite forward")
    rel32 = rel_rms(k32, ref)
    err_k, err_p = rel_rms(k16, ref), rel_rms(p16, ref)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    ok = rel32 <= DENOISER_F32_REL_RMS and err_k <= tol
    print(f"[G2b] forward B={B} T={T} through the kernels "
          f"(MOE_FUSED_KERNEL=1) vs use_kernels=False (switch unset): f32 "
          f"rel_rms={rel32:.3e} (tol {DENOISER_F32_REL_RMS:g}); bf16 "
          f"rel_rms to the f32 plain result: kernels {err_k:.3e}, plain "
          f"{err_p:.3e}; tol kernels <= {DENOISER_BF16_FACTOR:g} x plain + "
          f"{DENOISER_BF16_FLOOR:g} = {tol:.3e} -> {'ok' if ok else 'FAIL'}; "
          f"launches in the two kernel forwards {launches}, expected {want}")
    check(ok, "G2 forward")
    check(launches == want, f"G2 launches {launches}, expected {want}")

    # once more with use_fast_xattn: kernel 6 at head dim 256 in every
    # exact cross-attention block
    from motiondiffusion_moe_tpu_torch.models.attention import (
        CrossAttentionBlock)
    from motiondiffusion_moe_tpu_torch.ops import flash_attention as XA

    n_cross = 0
    for mod in (m32, mb):
        for x in mod.modules():
            if isinstance(x, CrossAttentionBlock):
                x.use_fast_xattn = True
                n_cross += mod is mb
    XA.xattn_fastlayout.launches = 0
    with torch.inference_mode():
        f32 = m32(*args, text_ids=ids)
        f16 = mb(*args, text_ids=ids)
        torch.cuda.synchronize()
    n6 = XA.xattn_fastlayout.launches
    rel32, err_k = rel_rms(f32, ref), rel_rms(f16, ref)
    ok = (bool(torch.isfinite(f32).all() and torch.isfinite(f16).all())
          and rel32 <= DENOISER_F32_REL_RMS and err_k <= tol)
    print(f"[G2b] the same forward with use_fast_xattn (kernel 6 at head "
          f"dim {hd}): f32 rel_rms to use_kernels=False {rel32:.3e} (tol "
          f"{DENOISER_F32_REL_RMS:g}); bf16 rel_rms to the f32 plain result "
          f"{err_k:.3e} (tol {tol:.3e}) -> {'ok' if ok else 'FAIL'}; "
          f"xattn_fastlayout launched {n6} times in the two forwards, "
          f"expected 2 x {n_cross} cross-attention blocks")
    check(ok, "G2 forward with use_fast_xattn")
    check(n6 == 2 * n_cross and n_cross > 0,
          f"G2 xattn_fastlayout launches {n6}, expected {2 * n_cross}")
    del mb, m32, ref, k32, k16, p16, f32, f16
    torch.cuda.empty_cache()

    # ---- G2c: two train steps through the train CLI
    counted = (P.favor_qkv, P.favor_qkv_bwd)
    for c in counted:
        c.launches = 0
    with tempfile.TemporaryDirectory() as d:
        state, _, times = run_train_cli(argv + [
            "--batch_size", str(B), "--synthetic_size", str(B),
            "--num_epochs", "1", "--device", "cuda", "--checkpoint_dir", d,
            "--log_every", "1"])
    launches = {c.__name__: c.launches for c in counted}
    check(state.step == 2, f"G2 train CLI took {state.step} steps")
    check(all(bool(torch.isfinite(p).all())
              for p in state.model.parameters()), "G2 non-finite weights")
    check(all(launches.values()), f"G2 train launches {launches}")
    print(f"[G2c] tools/train.py --model_size big --num_layers 2 on the card: "
          f"2 optimizer steps at batch {B}, ms per step "
          f"{', '.join(f'{x:.1f}' for x in times)}; launches {launches} "
          f"({card})")
    del state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# H: raw joints -> corpus -> training on the card
# ---------------------------------------------------------------------------

# (frames per second, walking speed per frame) of the synthetic raw clips:
# t2m 1.4 m/s at 20 fps, KIT's feet threshold (0.05) is 25x t2m's
RAW_CLIPS = {"t2m": (20.0, 0.07), "kit": (12.5, 0.4)}


def rest_pose(cfg, bone):
    """A rest pose [J, 3]: every child ``bone`` along its raw offset
    direction, the sideways bones off the spine (collar bones) 5/3 as
    long: shoulders wider than hips, as in a body (with equal widths the
    hips' and the shoulders' vectors cancel in the facing that IK takes
    from them)."""
    rest = np.zeros((len(cfg.raw_offsets), 3), np.float32)
    for chain in cfg.kinematic_chain:
        for a, b in zip(chain[:-1], chain[1:]):
            wide = a != 0 and cfg.raw_offsets[b][0] != 0
            rest[b] = rest[a] + bone * (5 / 3 if wide else 1) * \
                cfg.raw_offsets[b]
    return rest


def synth_raw_clips(root, dataset, lengths, seed):
    """Raw world joints [T, J, 3] of one clip per entry of ``lengths``,
    written as the dataset's raw files (t2m ``0010NN.npy`` with the default
    example ``000021``; KIT ``000NN_mmm_00.npy`` with ``03950_gt``): forward
    kinematics (the port's Skeleton) of smooth seeded rotations over a
    root that walks and stands in turns. While walking, every joint turns
    by ~0.005 rad a frame and the root moves at the dataset's walking speed
    along a drifting heading; while standing nothing moves. So a foot moves
    either not at all or about as fast as the root: its squared speed stays
    far from the contact threshold on both sides. Each clip turns the
    whole body by a seeded yaw, and the root bobs while walking."""
    from motiondiffusion_moe_tpu_torch.motion.process import ProcessConfig
    from motiondiffusion_moe_tpu_torch.motion.skeleton import Skeleton
    import torch

    cfg = ProcessConfig.t2m() if dataset == "t2m" else ProcessConfig.kit()
    J, bone = cfg.joints_num, 0.3
    speed = RAW_CLIPS[dataset][1]
    rest = rest_pose(cfg, bone)
    skel = Skeleton(cfg.raw_offsets, cfg.kinematic_chain)
    skel.get_offsets_joints(torch.from_numpy(rest))
    os.makedirs(root, exist_ok=True)
    names = []
    for i, T in enumerate(lengths):
        rng = np.random.default_rng(seed + i)
        walking = np.zeros(T, bool)
        t0, walk = 0, bool(rng.integers(2))
        while t0 < T:
            n = int(rng.integers(15, 40))
            walking[t0:t0 + n] = walk
            t0, walk = t0 + n, not walk
        steps = rng.standard_normal((T, J, 3)) * 0.005 * walking[:, None,
                                                                 None]
        # a pose of its own (~0.1 rad a joint: no bone exactly along or
        # against its offset, where IK's rotation between them is
        # undefined) and a yaw of the whole body, away from facing +-Z
        angles = (np.cumsum(steps, axis=0)
                  + 0.1 * rng.standard_normal((J, 3)))
        angles[:, 0, 1] += rng.choice([-1, 1]) * rng.uniform(0.5, 2.6)
        theta = np.linalg.norm(angles, axis=-1, keepdims=True)
        quat = np.concatenate([np.cos(theta / 2), 0.5 * np.sinc(
            theta / (2 * np.pi)) * angles], axis=-1)
        heading = np.cumsum(0.01 * walking) + rng.uniform(0, 2 * np.pi)
        vel = speed * walking[:, None] * np.stack(
            [np.cos(heading), np.sin(heading)], -1)
        xz = np.cumsum(vel, axis=0) - vel[0]
        bob = 0.02 * bone * np.sin(np.cumsum(0.3 * walking))
        root_pos = np.stack([xz[:, 0], 3 * bone + bob, xz[:, 1]], -1)
        joints = skel.forward_kinematics(
            torch.from_numpy(quat.astype(np.float32)),
            torch.from_numpy(root_pos.astype(np.float32))).numpy()
        if dataset == "t2m":
            name = "000021" if i == 0 else f"{1000 + i:06d}"
        else:
            name = "03950_gt" if i == 0 else f"{i:05d}_mmm_00"
        np.save(os.path.join(root, name + ".npy"), joints)
        names.append(name)
    return names


def write_texts(data_dir, subclips):
    """texts/<id>.txt and train.txt for every clip under new_joint_vecs/:
    two whole-clip captions each and, with ``subclips``, one
    ``f_tag#to_tag`` line of 50-189 frames at 20 fps, which the dataset
    makes an item of its own. Returns the ids."""
    ids = sorted(f[:-4] for f in os.listdir(
        os.path.join(data_dir, "new_joint_vecs")))
    os.makedirs(os.path.join(data_dir, "texts"), exist_ok=True)
    for i, name in enumerate(ids):
        lines = [f"a person walks and stands {i}#a/DET person/NOUN "
                 f"walk/VERB#0.0#0.0",
                 f"someone pauses on the way {i}#someone/PRON#nan#nan"]
        if subclips:
            f = 5 * (i % 4)
            lines.append(f"the person walks a little {i}#x/X#{f / 20}#"
                         f"{(f + 50 + (i * 37) % 140) / 20}")
        with open(os.path.join(data_dir, "texts", name + ".txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    with open(os.path.join(data_dir, "train.txt"), "w") as fh:
        fh.write("\n".join(ids) + "\n")
    return ids


def foot_margin(raw_dir, dataset):
    """Smallest relative distance of a squared foot speed from the contact
    threshold over the first 8 raw clips' global positions (process_file
    on the CPU): how far the contacts are from flipping."""
    from motiondiffusion_moe_tpu_torch.motion.process import (
        ProcessConfig, build_target_offsets, process_file)

    cfg = ProcessConfig.t2m() if dataset == "t2m" else ProcessConfig.kit()
    files = sorted(os.listdir(raw_dir))
    tgt = build_target_offsets(np.load(os.path.join(raw_dir, files[0])),
                               cfg)
    feet = list(cfg.fid_l) + list(cfg.fid_r)
    worst = np.inf
    for f in files[:8]:
        _, gp, _, _ = process_file(np.load(os.path.join(raw_dir, f)), cfg,
                                   tgt)
        d = gp[1:, feet] - gp[:-1, feet]
        worst = min(worst, float(np.abs((d ** 2).sum(-1) / cfg.feet_thre
                                        - 1).min()))
    return worst


H_LAYERS = 1  # H3's blocks a scale (full width), so I's and O4's too


def phase_h_and_i(card, d3_ms):
    """Raw joints -> prepare_data -> Text2MotionDataset with the native
    store -> tools/train.py --dataset t2m / kit on the card, at the
    flagship's full width and H_LAYERS blocks a scale. H1: 48 synthetic t2m clips of 60-240
    frames through prepare_data on the card and on the CPU; H2: the corpus
    read by Text2MotionDataset, native batches against the Python path;
    H3: 4 optimizer steps of the flagship on it (kernels 1 and 3 counted),
    2 with --no_native_io, 2 on a KIT corpus. Then phase I evaluates H3's
    t2m run on the same corpus; both live in one temporary directory."""
    with tempfile.TemporaryDirectory(prefix="phase_h_") as root:
        h = _phase_h(root, card, d3_ms)
        i = phase_i(root, h, card)
        t0 = time.perf_counter()
        phase_o4(root, h, card)
        print(f"[O4] {time.perf_counter() - t0:.1f} s (phase O's, run "
              "here, where phase I's run lives)")
        return h, i


def _phase_h(root, card, d3_ms):
    import torch
    from motiondiffusion_moe_tpu_torch.config import DataConfig
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.tools import prepare_data

    # ---- H1: prepare_data on the card and on the CPU
    j = os.path.join
    lengths = [60 + (i * 180) // 47 for i in range(48)]
    raw = j(root, "raw_t2m")
    synth_raw_clips(raw, "t2m", lengths, SEED + 70)
    out = {}
    secs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[device] = prepare_data.main(
            ["--dataset", "t2m", "--joints_dir", raw, "--out_dir",
             j(root, f"t2m_{device}"), "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
    check(out["cuda"] == out["cpu"] and out["cuda"]["kept"] == len(lengths)
          and out["cuda"]["skipped"] == 0 and out["cuda"]["dim"] == 263,
          f"H1 prepare_data summaries {out}")
    corpus = j(root, "t2m_cuda")
    for f in ("Mean.npy", "Std.npy", "meta/mean.npy", "meta/std.npy"):
        a = np.load(j(corpus, f))
        check(a.shape == (263,) and np.isfinite(a).all(), f"H1 {f}")
    diff, flips, frames = 0.0, 0, 0
    for f in sorted(os.listdir(j(corpus, "new_joint_vecs"))):
        a = np.load(j(corpus, "new_joint_vecs", f))
        b = np.load(j(root, "t2m_cpu", "new_joint_vecs", f))
        rec = np.load(j(corpus, "new_joints", f))
        check(a.shape[1] == 263 and np.isfinite(a).all()
              and rec.shape == (len(a), 22, 3) and np.isfinite(rec).all(),
              f"H1 {f}: features {a.shape}, joints {rec.shape}")
        diff = max(diff, float(np.abs(a - b).max()))
        flips += int((a[:, -4:] != b[:, -4:]).sum())
        frames += len(a)
    margin = foot_margin(raw, "t2m")
    print(f"[H1] prepare_data t2m: {len(lengths)} clips of "
          f"{min(lengths)}-{max(lengths)} frames, all kept, the round trip "
          f"finite; card {len(lengths) / secs['cuda']:.1f} clips/s "
          f"({secs['cuda']:.2f} s), CPU {len(lengths) / secs['cpu']:.1f} "
          f"clips/s ({secs['cpu']:.2f} s), host clock, the first card call "
          f"included; card vs CPU: max |features| diff {diff:.3e} (tol 1e-4), "
          f"{flips} of {4 * frames} foot contacts differ (tol 0; the "
          f"squared foot speeds stay >= {margin:.3f} of the threshold away "
          f"from it on the first 8 clips) ({card})")
    check(diff <= 1e-4 and flips == 0, "H1 card vs CPU")
    kit_lengths = [60 + (i * 139) // 39 for i in range(40)]
    raw_kit = j(root, "raw_kit")
    synth_raw_clips(raw_kit, "kit", kit_lengths, SEED + 80)
    kit = prepare_data.main(["--dataset", "kit", "--joints_dir", raw_kit,
                             "--out_dir", j(root, "kit")])
    check(kit["kept"] == len(kit_lengths) and kit["dim"] == 251,
          f"H1 KIT summary {kit}")
    print(f"[H1] prepare_data kit on the card: {kit}")

    # ---- H2: the corpus through Text2MotionDataset
    ids = write_texts(corpus, subclips=True)
    dcfg = DataConfig.humanml3d(data_root=corpus)
    ds = Text2MotionDataset(dcfg, split="train", seed=SEED)
    py = Text2MotionDataset(dcfg, split="train", seed=SEED, use_native=False)
    check(ds.has_native and not py.has_native, "H2 native store")
    check(ds.name_list == py.name_list, "H2 the same items")
    L = dcfg.max_motion_length
    short = [i for i in range(ds.real_len()) if ds.length_arr[i] < L]
    long = [i for i in range(ds.real_len()) if ds.length_arr[i] >= L]
    check(len(short) >= 32 and len(long) >= 1,
          f"H2 {len(short)} uncropped and {len(long)} cropped items")
    cn, mn, ln = ds.get_batch(short[:32], seed=3)
    cp, mp, lp = py.get_batch(short[:32], seed=3)
    err = float(np.abs(mn - mp).max())
    check(cn == cp and np.array_equal(ln, lp) and err <= 1e-6,
          f"H2 native vs Python batch: {err:.3e}")
    _, mc, lc = ds.get_batch(long * 8, seed=5)
    windows = 0
    for row, i in enumerate(long * 8):
        src = ds.normalizer.normalize_np(ds.data_dict[ds.name_list[i]]
                                         ["motion"])
        windows += any(np.allclose(src[s:s + L], mc[row], atol=1e-6)
                       for s in range(len(src) - L + 1))
    check(windows == len(long) * 8 and (lc == L).all(),
          f"H2 {windows} of {len(long) * 8} crops are windows")
    rng = np.random.default_rng(SEED + 90)
    idx = [rng.integers(0, len(ds), 32).tolist() for _ in range(20)]
    t0 = time.perf_counter()
    for b, ix in enumerate(idx):
        ds.get_batch(ix, seed=b)
    nat_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
    t0 = time.perf_counter()
    for b, ix in enumerate(idx):
        py.get_batch(ix, seed=b)
    py_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
    print(f"[H2] Text2MotionDataset: {ds.real_len()} items ({len(short)} "
          f"shorter than {L} frames, {len(long)} cropped) from "
          f"{len(lengths)} clips with their sub-clips; native store: the "
          f"uncropped batch equals the Python path's within {err:.1e} (tol "
          f"1e-6), {windows} crops all windows of their sources; host ms "
          f"per batch of 32: native {nat_ms:.3f}, Python {py_ms:.3f}")

    # ---- H3: tools/train.py on the corpus, the flagship at full width
    counted = (P.favor_qkv, P.favor_qkv_bwd)
    base = ["--device", "cuda", "--batch_size", "32", "--num_epochs", "1",
            "--log_every", "1", "--num_layers", str(H_LAYERS)]
    steps_want = 2 * (len(ds) // 32)
    check(steps_want == 4, f"H3 corpus gives {steps_want} steps, not 4")

    def train(label, argv, steps, keep=None):
        """``keep``: the checkpoint dir to write and keep (phase I reads
        the run); else a temporary one."""
        for c in counted:
            c.launches = 0
        with contextlib.ExitStack() as stack:
            ck = keep or stack.enter_context(
                tempfile.TemporaryDirectory(dir=root))
            state, log, times = run_train_cli(
                argv + base + ["--checkpoint_dir", ck])
            meta = MotionNormalizer.load(j(ck, "t2m_moe_small", "meta"))
        launches = {c.__name__: c.launches for c in counted}
        losses = [float(v) for v in re.findall(r"loss_total: (\S+)", log)]
        n_perf = 2 * 2 * state.model.config.num_layers
        ok = (state.step == steps and len(losses) == steps
              and all(math.isfinite(v) for v in losses)
              and launches == {"favor_qkv": n_perf * steps,
                               "favor_qkv_bwd": n_perf * steps})
        ms = float(np.median(times[1:]))
        print(f"[H3] {label}: {state.step} optimizer steps (latent "
              f"{state.model.config.latent_dim}, "
              f"{state.model.config.num_layers} blocks per scale, "
              f"{state.model.config.input_feats} features, dropout "
              f"{state.model.config.dropout}); losses {losses}; launches "
              f"{launches}, expected {n_perf} x {steps} each; ms per step "
              f"{', '.join(f'{x:.1f}' for x in times)}, median after the "
              f"first {ms:.1f} ({card}) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"H3 {label}")
        check(all(bool(torch.isfinite(p).all())
                  for p in state.model.parameters()), f"H3 {label} weights")
        del state
        torch.cuda.empty_cache()
        return meta, ms

    run_root = j(root, "run_t2m")
    meta, ms = train("--dataset t2m, native store",
                     ["--dataset", "t2m", "--data_root", corpus], 4,
                     keep=run_root)
    check(meta.mean.tobytes() == ds.normalizer.mean.tobytes()
          and meta.std.tobytes() == ds.normalizer.std.tobytes(),
          "H3 meta/ is not the dataset's normalizer")
    print(f"[H3] ms per optimizer step on the t2m corpus {ms:.1f}, on D3's "
          f"synthetic dataset {d3_ms:.1f} (medians, this run; {card}); "
          f"meta/ equals the dataset's normalizer")
    # 2 steps through the Python path: a corpus of 20 ids (40 items)
    sub = j(root, "t2m_python")
    os.makedirs(sub)
    for d in ("new_joint_vecs", "texts"):
        os.symlink(j(corpus, d), j(sub, d))
    with open(j(sub, "train.txt"), "w") as fh:
        fh.write("\n".join(ids[:20]) + "\n")
    train("--dataset t2m --no_native_io",
          ["--dataset", "t2m", "--data_root", sub, "--no_native_io"], 2)
    write_texts(j(root, "kit"), subclips=False)
    train("--dataset kit", ["--dataset", "kit", "--data_root",
                            j(root, "kit")], 2)
    return {"clips_per_s": len(lengths) / secs["cuda"],
            "native_ms": nat_ms, "python_ms": py_ms, "ms_per_step": ms,
            "corpus": corpus, "ids": ids,
            "run_dir": j(run_root, "t2m_moe_small")}


# ---------------------------------------------------------------------------
# I: evaluating the trained flagship
# ---------------------------------------------------------------------------

GLOVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "fixtures", "glove")
# the protocol cut to what H's 74-item test split holds and to about a
# minute and a half of the card (the reference's: retrieval pools of 512,
# diversity 300, mm 100 x 30, mm times 10, 20 replications, every test
# sample scored in joint space, the 1000-step DDPM); each cut is printed
I_MB, I_MM, I_REPS, I_SCORE = 16, 4, 6, 32
I_PROTOCOL = ["--sampler", "dpm", "--steps", "20", "--batch_size",
              str(I_MB), "--protocol_batch_size", "32", "--diversity_times",
              "30", "--mm_num_samples", str(I_MM), "--mm_num_repeats",
              str(I_REPS), "--mm_num_times", "3"]
METRICS = ("Matching Score", "R_precision", "FID", "Diversity",
           "MultiModality")


def write_finest_tar(path, dim_pose=263, seed=SEED + 100):
    """A finest.tar with the released evaluator's layout and shapes (the
    reference's torch modules: the movement conv encoder, the text and
    motion BiGRU co-encoders, text hidden 512, motion hidden 1024,
    co-embedding 512), seeded weights."""
    import torch
    from torch import nn

    def co(input_size, hidden, with_pos):
        m = nn.Module()
        if with_pos:
            m.pos_emb = nn.Linear(15, 300)
        m.input_emb = nn.Linear(input_size, hidden)
        m.gru = nn.GRU(hidden, hidden, batch_first=True, bidirectional=True)
        m.output_net = nn.Sequential(
            nn.Linear(hidden * 2, hidden), nn.LayerNorm(hidden),
            nn.LeakyReLU(0.2), nn.Linear(hidden, 512))
        m.hidden = nn.Parameter(torch.randn(2, 1, hidden))
        return m

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        mov = nn.Module()
        mov.main = nn.Sequential(
            nn.Conv1d(dim_pose - 4, 512, 4, 2, 1), nn.Dropout(0.2),
            nn.LeakyReLU(0.2), nn.Conv1d(512, 512, 4, 2, 1),
            nn.Dropout(0.2), nn.LeakyReLU(0.2))
        mov.out_net = nn.Linear(512, 512)
        torch.save({"movement_encoder": mov.state_dict(),
                    "text_encoder": co(300, 512, True).state_dict(),
                    "motion_encoder": co(512, 1024, False).state_dict()},
                   path)


@contextlib.contextmanager
def patched(*patches):
    """Set (owner, attribute, value) for the block, then restore."""
    old = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, v in patches:
        setattr(o, a, v)
    try:
        yield
    finally:
        for o, a, v in old:
            setattr(o, a, v)


def phase_i(root, h, card, dev="cuda"):
    """The trained flagship of H3 evaluated on H's corpus (a test split over
    its ids, a real-shaped finest.tar with seeded weights, the committed
    GloVe fixture). I1: tools/evaluate.main on the card, host path, dpm20,
    1 replication; I2: --device_embeddings, replication 0 against I1's;
    I3: the evaluator on the card against the CPU; I4: the unguided DDPM
    loop, DDIM with a classifier gradient and the bits-per-dim loop through
    the flagship's conditional branch on a respaced 50-step schedule."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import DataConfig
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.eval import evaluator_models as EM
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools import evaluate

    j = os.path.join
    corpus, run_dir = h["corpus"], h["run_dir"]
    with open(j(corpus, "test.txt"), "w") as fh:
        fh.write("\n".join(h["ids"]) + "\n")
    finest = j(root, "finest.tar")
    write_finest_tar(finest)
    n = len(Text2MotionDataset(DataConfig.humanml3d(data_root=corpus),
                               split="test", use_native=False).name_list)
    prompts = n + min(I_MM, n) * (I_REPS - 1)  # per replication
    n_perf, fwd = 2 * 2 * H_LAYERS, 21  # Performers a forward, dpm20's
    counted = (P.favor_qkv, P.performer_epilogue)
    print(f"[I] cuts: test split {n} items (HumanML3D's 4,384), retrieval "
          f"pools of 32 (512; {n - n % 32} items pooled, the ragged tail "
          f"dropped as the reference's loaders drop it), diversity 30 "
          f"(300), mm {I_MM} x {I_REPS} (100 x 30), mm times 3 (10), "
          f"dpm20 (the CLI's DDPM 1000), generation micro-batch {I_MB}; "
          f"I1 1 replication (20), joint scores over {I_SCORE} samples "
          f"(all); I2 1 replication, no joint scores; {prompts} prompts "
          f"per replication")

    gen_s, gen_n, pool_ms, fetched = [], [], [], [0]

    def timed(fn):
        def run(self, captions, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, captions, *a, **k)
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            gen_n.append(len(captions))
            return out
        return run

    co = EM.EvaluatorModelWrapper.get_co_embeddings

    def timed_co(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = co(self, *a)  # numpy: the copy waits for the card
        pool_ms.append((len(out[0]), (time.perf_counter() - t0) * 1e3))
        return out

    micro = GenerationPipeline._micro_batches

    def counted_micro(self, *a, **k):
        for host, lens, rows in micro(self, *a, **k):
            fetched[0] += host.nbytes
            yield host, lens, rows

    def run_cli(label, extra):
        for c in counted:
            c.launches = 0
        gen_s.clear(), gen_n.clear(), pool_ms.clear()
        fetched[0] = 0
        log_file = j(root, f"{label}.log")
        t0 = time.perf_counter()
        with patched(
                (GenerationPipeline, "generate",
                 timed(GenerationPipeline.generate)),
                (GenerationPipeline, "generate_motion_embeddings",
                 timed(GenerationPipeline.generate_motion_embeddings)),
                (GenerationPipeline, "_micro_batches", counted_micro),
                (EM.EvaluatorModelWrapper, "get_co_embeddings", timed_co)):
            res = evaluate.main(
                ["--run_dir", run_dir, "--device", str(dev), "--evaluator_ckpt",
                 finest, "--glove_dir", GLOVE, "--log_file", log_file]
                + I_PROTOCOL + extra)
        secs = time.perf_counter() - t0
        with open(log_file) as fh:
            log = fh.read()
        launches = {c.__name__: c.launches for c in counted}
        for metric, per_model in res["summary"].items():
            for model, (mean, ci) in per_model.items():
                check(np.all(np.isfinite(mean)) and np.all(np.isfinite(ci)),
                      f"{label} {metric} [{model}] {mean} {ci}")
        for metric in METRICS:
            check(f"========== {metric} Summary ==========" in log,
                  f"{label}: the log lacks the {metric} summary")
        reps = [float(x) for x in
                re.findall(r"replication total ([\d.]+)s", log)]
        pools = [ms for rows, ms in pool_ms if rows == 32]
        print(f"[{label.upper()}] tools/evaluate.main {secs:.1f} s; "
              f"seconds per replication (the protocol's clock) {reps}; "
              f"generation {sum(gen_n)} motions in {sum(gen_s):.3f} s = "
              f"{sum(gen_s) / max(1, sum(gen_n)):.4f} s/motion; evaluator "
              f"ms per pool of 32 (co-embeddings, {len(pools)} pools) "
              f"median {np.median(pools) if pools else float('nan'):.2f}; "
              f"bytes fetched from the card by the sampler {fetched[0]} "
              f"({fetched[0] / max(1, sum(gen_n)):.0f} a motion); launches "
              f"{launches} ({card})")
        return res, launches, sum(gen_n)

    # ---- I1: the host path, 1 replication, joint scores
    res1, l1, made1 = run_cli("i1", ["--replication_times", "1",
                                     "--score_samples", str(I_SCORE)])
    mbs = math.ceil(prompts / I_MB) + math.ceil(I_SCORE / I_MB)
    want = n_perf * fwd * mbs
    check(made1 == prompts + I_SCORE, f"I1 generated {made1} motions")
    check(l1 == {"favor_qkv": want, "performer_epilogue": want},
          f"I1 launches {l1}, expected {n_perf} x {fwd} x {mbs} = {want}")
    mae, vel, jerk = res1["joint"]
    check(np.isfinite(mae).all() and math.isfinite(vel)
          and math.isfinite(jerk), "I1 joint-space scores")
    name = "t2m_moe_small"
    summary = {m: {k: np.round(np.asarray(v[0]), 4).tolist()
                   for k, v in res1["summary"][m].items()} for m in METRICS}
    print(f"[I1] summary means {summary}; MAE {float(mae.mean()):.4f}, "
          f"velocity error {vel:.4f}, jerk error {jerk:.4f} (random "
          f"weights, a few training steps: not comparable to published "
          f"numbers); kernels 1 and 2 launched {want} times each = "
          f"{n_perf} x {fwd} forwards x {mbs} micro-batches, as expected")

    # ---- I2: the fused sample-and-embed path, replication 0
    res2, l2, made2 = run_cli("i2", ["--replication_times", "1",
                                     "--device_embeddings",
                                     "--skip_joint_scores"])
    mbs2 = math.ceil(prompts / I_MB)
    want2 = n_perf * fwd * mbs2
    check(l2 == {"favor_qkv": want2, "performer_epilogue": want2},
          f"I2 launches {l2}, expected {want2}")
    worst = 0.0
    for metric in ("Matching Score", "R_precision", "FID"):
        for model in res2["per_replication"][metric]:
            a = np.asarray(res1["per_replication"][metric][model][0])
            b = np.asarray(res2["per_replication"][metric][model][0])
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(a),
                                                          1e-12)))
            worst = max(worst, rel)
            check(rel <= 1e-4, f"I2 {metric} [{model}]: {b} vs I1's {a}")
    print(f"[I2] --device_embeddings replication 0 against I1's: Matching "
          f"Score, R-precision and FID within {worst:.2e} relative (tol "
          f"1e-4); {made2} motions, only their co-embeddings fetched")

    # ---- I3: the evaluator on the card against the CPU
    i3 = phase_i3(run_dir, finest, card, dev)

    # ---- I4: the rest of the diffusion code through the flagship
    phase_i4(run_dir, card, dev)
    return {"summary": summary, **i3}


def phase_i3(run_dir, finest, card, dev="cuda"):
    """One ground-truth pool of 32 through the evaluator on the card (f32,
    TF32 off) and on the CPU, the same weights; also with cuDNN's TF32 on,
    PyTorch's default."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.eval import (
        EvaluatorModelWrapper, get_word_vectorizer, make_batches)
    from motiondiffusion_moe_tpu_torch.tools.evaluate import (
        build_eval_samples)
    from motiondiffusion_moe_tpu_torch.tools.export import load_run

    cfg, _, _, normalizer = load_run(run_dir)
    ds = Text2MotionDataset(cfg.data, split="test", normalizer=normalizer,
                            use_native=False)
    samples = build_eval_samples(ds)[:32]
    batch = make_batches(samples, get_word_vectorizer(GLOVE), 32)[0]
    args = (batch.word_embs, batch.pos_ohots, batch.sent_lens,
            batch.motions, batch.m_lens)
    out, ms = {}, {}
    wrappers = {d: EvaluatorModelWrapper.from_torch_checkpoint(finest,
                                                               device=d)
                for d in (str(dev), "cpu")}
    for device, w in wrappers.items():
        out[device] = w.get_co_embeddings(*args)
        iters = 10 if device == "cuda" else 2
        t0 = time.perf_counter()
        for _ in range(iters):
            w.get_co_embeddings(*args)  # numpy: waits for the card
        ms[device] = (time.perf_counter() - t0) * 1e3 / iters
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = wrappers[str(dev)].get_co_embeddings(*args)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    errs = [float(np.abs(o - r).max() / np.abs(r).max())
            for o, r in zip(out[str(dev)], out["cpu"])]
    tf32_errs = [float(np.abs(o - r).max() / np.abs(r).max())
                 for o, r in zip(tf32, out[str(dev)])]
    print(f"[I3] evaluator co-embeddings of one pool of 32 (text, motion): "
          f"card vs CPU {errs[0]:.3e}, {errs[1]:.3e} of their largest "
          f"value (tol 1e-4); ms per pool: card {ms[str(dev)]:.2f}, CPU "
          f"{ms['cpu']:.2f}; with cudnn.allow_tf32=True (PyTorch's default) "
          f"the card's are {tf32_errs[0]:.3e}, {tf32_errs[1]:.3e} of their "
          f"largest value from its f32 ones ({card})")
    check(max(errs) <= 1e-4, "I3 the evaluator on the card vs the CPU")
    return {"pool_ms_card": ms[str(dev)], "pool_ms_cpu": ms["cpu"],
            "tf32_rel": max(tf32_errs)}


def phase_i4(run_dir, card, dev="cuda"):
    """ddpm_sample_loop, ddim_sample_loop(cond_fn=...) and calc_bpd_loop at
    B = 4 through the run's conditional branch (no CFG), each on a 50-step
    schedule respaced from the run's 1000: finite, 50 x (Performers per
    forward) launches of kernels 1 and 2 per loop."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.diffusion import (
        ModelMeanType, ModelVarType, ddim_sample_loop, ddpm_sample_loop,
        make_schedule, respace_schedule, space_timesteps)
    from motiondiffusion_moe_tpu_torch.diffusion.guidance import (
        calc_bpd_loop)
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.evaluate import (
        build_eval_samples)
    from motiondiffusion_moe_tpu_torch.tools.export import load_run

    cfg, sd, _, normalizer = load_run(run_dir)
    n_perf = 2 * 2 * cfg.model.num_layers
    model = GenerationPipeline(cfg, params=sd, device=dev).model
    dc = cfg.diffusion
    base = make_schedule(schedule_name=dc.beta_schedule,
                         num_timesteps=dc.num_timesteps, device=dev)
    sched, tmap = respace_schedule(
        base.betas.double().cpu().numpy(),
        space_timesteps(dc.num_timesteps, "ddim50"), device=dev)
    tmap = torch.as_tensor(tmap, dtype=torch.long, device=dev)
    samples = build_eval_samples(Text2MotionDataset(
        cfg.data, split="test", normalizer=normalizer, use_native=False))[:4]
    gt = torch.from_numpy(np.stack([s.motion for s in samples])).to(dev)
    lengths = torch.tensor([s.m_length for s in samples], device=dev)
    kw = dict(mean_type=ModelMeanType(dc.model_mean_type),
              var_type=ModelVarType(dc.model_var_type))
    g = torch.Generator(dev).manual_seed(SEED + 110)
    counted = (P.favor_qkv, P.performer_epilogue)
    with torch.inference_mode():
        enc = model.encode_text(torch.from_numpy(hash_tokenize(
            [s.caption for s in samples], cfg.model.text_max_tokens)).to(dev))

        def model_fn(x, t):  # the conditional branch alone
            return model(x, t, lengths, xf_proj=enc.pooled,
                         xf_out=enc.tokens)

        def cond_fn(x, t):  # grad log N(gt, 20^2 I) at x
            return (gt - x) / 400.0

        noise = torch.randn(gt.shape, generator=g, device=dev)
        loops = (
            ("ddpm_sample_loop", lambda: ddpm_sample_loop(
                sched, model_fn, noise, generator=g, timestep_map=tmap,
                clip_denoised=dc.clip_denoised, **kw)),
            ("ddim_sample_loop(cond_fn)", lambda: ddim_sample_loop(
                sched, model_fn, noise, generator=g, timestep_map=tmap,
                cond_fn=cond_fn, clip_denoised=dc.clip_denoised, **kw)),
            ("calc_bpd_loop", lambda: calc_bpd_loop(
                sched, lambda x, t: model_fn(x, tmap[t]), gt, generator=g,
                **kw)))
        for name, run in loops:
            for c in counted:
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {c.__name__: c.launches for c in counted}
            tensors = [out] if isinstance(out, torch.Tensor) else list(
                out.values())
            finite = all(bool(torch.isfinite(v).all()) for v in tensors)
            shown = (f"bpd {out['total_bpd'].tolist()}"
                     if isinstance(out, dict) else
                     f"out {tuple(out.shape)} max|x| "
                     f"{float(out.abs().max()):.3f}")
            print(f"[I4] {name}: 50 steps at B = 4 in {ms:.1f} ms "
                  f"({ms / 50:.2f} ms a step), {shown}, finite {finite}, "
                  f"launches {launches} ({card})")
            check(finite and launches == {"favor_qkv": 50 * n_perf,
                                          "performer_epilogue": 50 * n_perf},
                  f"I4 {name}: finite {finite}, launches {launches}")


def deberta_work(dc, B: int, T: int, out_dim: int, prompts: int):
    """(bytes, operations) of one DeBERTa encode of B prompts x T tokens in
    f32. Operations (a multiply-add is 2): per layer the q / k / v,
    attention-output and FFN products over B*T rows, the position key /
    query projections over the 2 x buckets rows of the relative table,
    q.k and probs.v, and c2p / p2c over the table; then the head over
    B x (prompts + T) rows. Bytes: every weight read once (of the
    embedding table only the B*T gathered rows), the ids read and the
    tokens and pooled rows written once."""
    C, I, S = dc.hidden_size, dc.intermediate_size, dc.position_buckets
    rows = B * T
    layer = (2 * rows * C * C * 4 + 2 * (2 * S) * C * C * 2
             + 2 * B * T * T * C * 2 + 2 * B * T * (2 * S) * C * 2
             + 2 * rows * C * I * 2)
    flops = dc.num_hidden_layers * layer + 2 * B * (prompts + T) * C * out_dim
    weights = (dc.num_hidden_layers * (4 * C * C + 2 * C * I + 9 * C + I)
               + 2 * S * C + 4 * C + prompts * C + C * out_dim + out_dim)
    nbytes = (4 * (weights + rows * C) + 8 * rows
              + 4 * B * (prompts + T + 1) * out_dim)
    return nbytes, flops


J_LAYERS = 1  # J's denoiser's blocks a scale (full width)


def phase_j(cfg, dev, card, c_timings, d3_ms):
    """The flagship with text_encoder="deberta-v3-large": J1 the encoder on
    the card against the CPU, J2 sampling behind make_server, J3 the train
    CLI grafting a seeded HF-layout checkpoint (see the module doc)."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    jcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, text_encoder="deberta-v3-large", num_layers=J_LAYERS))
    t0 = time.perf_counter()
    model = MotionTransformer(jcfg.model)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    init_weights(model, SEED)
    t_init = time.perf_counter() - t0
    perturb_zero_init(model)
    n_enc = sum(p.numel() for p in model.text_encoder.parameters())
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[J1] flagship + deberta-v3-large: {n_all} parameters, "
          f"{n_enc} of them the text encoder; built in {t_build:.1f} s, "
          f"init_weights (one CPU torch.Generator, "
          f"{torch.get_num_threads()} threads) {t_init:.1f} s")
    phase_j1(model, dev, card)
    phase_j2(jcfg, model, dev, card, c_timings)
    del model
    torch.cuda.empty_cache()
    phase_j3(jcfg, dev, card, d3_ms)


def phase_j1(model, dev, card):
    import torch
    from motiondiffusion_moe_tpu_torch.models import deberta as TD

    enc = model.text_encoder.eval()
    dc = enc.bert.cfg
    tok = TD.get_deberta_tokenizer(model.config.text_max_tokens,
                                   dc.vocab_size)
    ids = torch.from_numpy(tok([
        "a person walks forward", "",
        "a man jumps twice and then sits down on the floor slowly",
        "turn left"]))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = enc(ids)
    cpu_s = time.perf_counter() - t0
    enc.to(dev)
    try:
        with torch.no_grad():
            out = enc(ids.to(dev))
        torch.cuda.synchronize()
        for name, a, b in (("pooled", out.pooled, ref.pooled),
                           ("tokens", out.tokens, ref.tokens)):
            check(a.is_cuda and a.dtype == torch.float32,
                  f"J1 {name} on {a.device} in {a.dtype}")
            check(bool(torch.isfinite(a).all()), f"J1 {name} not finite")
            err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
            print(f"[J1] {name} {tuple(a.shape)}: card vs CPU max error "
                  f"{err:.3e} of the largest value (tolerance "
                  f"{DEBERTA_REL:g})")
            check(err <= DEBERTA_REL, f"J1 {name} error {err:.3e}")
        B = 32
        prompts = [f"a person performs action number {i}" for i in
                   range(B // 2)] + [""] * (B // 2)
        ids32 = torch.from_numpy(tok(prompts)).to(dev)

        def encode():
            with torch.inference_mode():
                enc(ids32)

        ms = time_ms(encode, iters=10)
        nbytes, flops = deberta_work(dc, B, ids32.shape[1],
                                     enc.proj_dense.weight.shape[0],
                                     enc.prompt_tokens.shape[1])
        b_ms, b_by = bound(nbytes, flops, "f32")
        print(f"[J1] one encode of {B} prompts x {ids32.shape[1]} tokens "
              f"(f32, TF32 off): {ms:.3f} ms per call (CUDA events), "
              f"device {device_ms(encode, iters=5)} (by kernel: "
              f"{device_ms_by_kernel(encode, iters=5)}); {flops / 1e12:.3f} "
              f"TFLOP, {flops / ms / 1e9:.1f} TFLOP/s; bound {b_ms:.3f} ms "
              f"({b_by}, f32 at {PEAK_FLOPS['f32'] / 1e12:.0f} TFLOP/s); "
              f"the CPU encode of 4 prompts {cpu_s:.2f} s ({card})")
    finally:
        enc.cpu()
        torch.cuda.empty_cache()


def phase_j2(jcfg, model, dev, card, c_timings):
    import torch
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.serve import make_server

    t0 = time.perf_counter()
    pipe = GenerationPipeline(jcfg, model, sampler="dpm",
                              num_inference_steps=20, micro_batch=16,
                              param_dtype="bfloat16", device=dev)
    pipe.normalizer = MotionNormalizer.identity(jcfg.data.dim_pose)
    bert = pipe.model.text_encoder.bert
    check(bert.word_embeddings.weight.dtype == torch.bfloat16
          and bert.rel_embeddings.is_cuda, "J2 the backbone's storage")
    print(f"[J2] pipeline built (bf16 weights on the card) in "
          f"{time.perf_counter() - t0:.1f} s")
    j2_denoiser_bf16(jcfg, pipe, dev)
    n_perf = 2 * 2 * jcfg.model.num_layers  # Performers per forward
    T, F = jcfg.model.max_frames, jcfg.model.input_feats
    samples, encodes = [], []
    sample = pipe.sample

    def counted_sample(*a, **k):
        samples.append(1)
        return sample(*a, **k)

    pipe.sample = counted_sample
    hook = pipe.model.text_encoder.register_forward_hook(
        lambda m, args, out: encodes.append(
            (args[0].device.type, out.tokens.device.type,
             tuple(out.tokens.shape))))
    pipe.generate(["warm up"], [T])
    srv = make_server(pipe, port=0, max_batch=64)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    counted = (P.favor_qkv, P.performer_epilogue)
    try:
        for c in counted:
            c.launches = 0
        samples.clear()
        encodes.clear()
        texts = ["a person walks forward", "kick the ball hard", "",
                 "dance slowly", "sit down", "a person waves with the left "
                 "hand", "jump twice", "walk in a circle and then stop",
                 "run", "climb the stairs", "bow", "turn around", "crouch",
                 "throw a ball overhand with the right arm", "stretch",
                 "a man stumbles and falls"]
        lens = [min(n, T) for n in (1, 40, 57, 98, 120, 133, 150, 196)] * 2
        status, body = _post(url + "/generate",
                             {"texts": texts, "lengths": lens})
        check(status == 200, f"J2 HTTP {status}")
        motions = [np.asarray(mo, dtype=np.float32) for mo in body["motions"]]
        check([list(mo.shape) for mo in motions] == [[n, F] for n in lens],
              f"J2 shapes {body['shapes']}")
        check(all(np.isfinite(mo).all() for mo in motions),
              "J2 non-finite motion")
        fwd = len(samples) * pipe.forwards_per_sample
        launches = {c.__name__: c.launches for c in counted}
        print(f"[J2] 16 prompts at lengths {lens}: HTTP 200, finite; "
              f"{len(samples)} micro-batch samples x "
              f"{pipe.forwards_per_sample} forwards = {fwd} forwards; "
              f"launches {launches}, expected {n_perf} x {fwd} = "
              f"{n_perf * fwd} each; text encoder forwards {len(encodes)} "
              f"{sorted(set(encodes))}, expected 2 x {len(samples)}")
        check(all(n == n_perf * fwd for n in launches.values()),
              "J2 launch counts")
        check(len(encodes) == 2 * len(samples)
              and all(i == o == "cuda" for i, o, _ in encodes),
              "J2 text encoder runs")
    finally:
        srv.shutdown()
        srv.server_close()
        hook.remove()
    pipe.sample = sample
    prompts = [f"a person performs action number {i}" for i in range(16)]
    pipe.generate(prompts, [T] * 16)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.generate(prompts, [T] * 16,
                        generator=torch.Generator(dev).manual_seed(7))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    check(all(np.isfinite(o).all() for o in out), "J2 dpm20 non-finite")
    print(f"[J2] dpm20 generate 16 prompts x {T} frames with "
          f"deberta-v3-large (CFG, micro_batch 16, bf16 weights): {s:.3f} s, "
          f"{s / 16:.4f} s/motion; phase C's hash encoder "
          f"{c_timings['dpm20'] / 16:.4f} s/motion (this run; {card})")
    del pipe
    torch.cuda.empty_cache()


def j2_denoiser_bf16(jcfg, pipe, dev):
    """Phase B's bf16 rule behind DeBERTa: the served model (bf16 weights,
    bf16 compute, the MoE FFN fed by deberta-v3-large's f32 encodings)
    through the kernels and with use_kernels=False, both held to the same
    weights in f32 compute. Prints how many top-2 routings the two paths
    chose differently."""
    import torch
    from motiondiffusion_moe_tpu_torch.models import moe as TM
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    args, ids = denoiser_inputs(jcfg, dev, tokenize=pipe.tokenize)
    with torch.device(dev):
        m32 = MotionTransformer(dataclasses.replace(jcfg.model,
                                                    dtype="float32"))
    m32.load_state_dict(pipe.model.state_dict())
    with torch.inference_mode():
        ref = m32.eval()(*args, text_ids=ids)
    del m32
    m, own = pipe.model, TM.top_k_lowest_index
    outs, routes = {}, {}
    try:
        for kernels in (True, False):
            chosen = routes[kernels] = []

            def top_k(probs, k):
                vals, idx = own(probs, k)
                chosen.append(idx.sort(-1).values)
                return vals, idx

            TM.top_k_lowest_index = top_k
            m.set_use_kernels(kernels)
            with torch.inference_mode():
                outs[kernels] = m(*args, text_ids=ids)
    finally:
        TM.top_k_lowest_index = own
        m.set_use_kernels(True)
    torch.cuda.synchronize()
    for out in outs.values():
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              "J2 denoiser output")
    err_k, err_p = rel_rms(outs[True], ref), rel_rms(outs[False], ref)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    n = sum(a.shape[0] for a in routes[True])
    flips = sum(int((a != b).any(-1).sum())
                for a, b in zip(routes[True], routes[False]))
    print(f"[J2] flagship denoiser behind deberta-v3-large, bf16 weights and "
          f"compute, B={args[0].shape[0]} T={args[0].shape[1]}: rel_rms to "
          f"the f32 result: kernels {err_k:.3e}, use_kernels=False "
          f"{err_p:.3e}; top-2 routings that differ between the two "
          f"{flips} of {n}; tol kernels <= {DENOISER_BF16_FACTOR:g} x "
          f"use_kernels=False + {DENOISER_BF16_FLOOR:g} = {tol:.3e} -> "
          f"{'ok' if err_k <= tol else 'FAIL'}")
    check(err_k <= tol, "J2 denoiser (bfloat16) kernels vs plain")


def phase_j3(jcfg, dev, card, d3_ms):
    import torch
    from motiondiffusion_moe_tpu_torch.models import deberta as TD
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    dc = TD.deberta_config(jcfg.model.text_encoder)
    with tempfile.TemporaryDirectory(prefix="phase_j_") as root:
        ckdir = os.path.join(root, "deberta-v3-large")
        os.makedirs(ckdir)
        with torch.device("meta"):
            shapes = TD.DebertaEncoder(dc).state_dict()
        g = torch.Generator(dev).manual_seed(SEED + 40)
        hf = {}
        for ours, theirs in TD.hf_deberta_names(dc).items():
            x = 0.02 * torch.randn(shapes[ours].shape, generator=g,
                                   device=dev)
            hf[theirs] = (x + 1.0 if ours.endswith("norm.weight")
                          else x).half().cpu()
        path = os.path.join(ckdir, "pytorch_model.bin")
        t0 = time.perf_counter()
        torch.save(hf, path)
        print(f"[J3] seeded HF-layout checkpoint: {len(hf)} half-precision "
              f"tensors, {os.path.getsize(path) / 1e9:.3f} GB written in "
              f"{time.perf_counter() - t0:.1f} s")
        want = {k: v.to(dev).float() for k, v in
                TD.convert_hf_deberta_checkpoint(hf, dc).items()}
        del hf
        at_init = {}
        init_state = Trainer.init_state

        def checked_init(self):
            state = init_state(self)
            bert = state.model.text_encoder.bert.state_dict()
            names = [n for n, _ in state.model.named_parameters()]
            ema = dict(zip(names, state.ema.params))
            at_init["params"] = all(torch.equal(bert[k], v)
                                    for k, v in want.items())
            at_init["ema"] = all(torch.equal(
                ema[f"text_encoder.bert.{k}"], v) for k, v in want.items())
            return state

        counted = (P.favor_qkv, P.favor_qkv_bwd, P.performer_epilogue,
                   P.performer_epilogue_bwd)
        for c in counted:
            c.launches = 0
        argv = ["--dataset", "synthetic", "--synthetic_size", "32",
                "--batch_size", "32", "--num_epochs", "1", "--device", "cuda",
                "--log_every", "1", "--ema_decay", "0.9999",
                "--text_encoder", "deberta-v3-large", "--deberta_ckpt", ckdir,
                "--num_layers", str(jcfg.model.num_layers),
                "--checkpoint_dir", os.path.join(root, "runs")]
        t0 = time.perf_counter()
        with patched((Trainer, "init_state", checked_init)):
            state, log, times = run_train_cli(argv)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counted}
        losses = [float(v) for v in re.findall(r"loss_total: (\S+)", log)]
        print(f"[J3] grafted backbone equal to the file's tensors (cast to "
              f"f32) at step 0: {at_init.get('params')}, its EMA: "
              f"{at_init.get('ema')} ({len(want)} tensors)")
        check(at_init.get("params") is True and at_init.get("ema") is True,
              "J3 graft")
        check(state.step == 2 and len(losses) == 2
              and all(math.isfinite(v) for v in losses),
              f"J3 {state.step} steps, losses {losses}")
        bert = state.model.text_encoder.bert.state_dict()
        # the head starts at zero, so the first step sends no gradient
        # upstream and the second a small one: Adam (eps 1e-8) moves the
        # tensors whose gradients stand above its eps
        moved = {k for k, v in want.items() if not torch.equal(bert[k], v)}
        layers_moved = all(any(k.startswith(f"layer_{i}.") for k in moved)
                           for i in range(dc.num_hidden_layers))
        n_perf = 2 * 2 * jcfg.model.num_layers
        expect = {"favor_qkv": n_perf * 2, "favor_qkv_bwd": n_perf * 2,
                  "performer_epilogue": 0, "performer_epilogue_bwd": 0}
        ckpt = os.path.join(root, "runs", "t2m_moe_small", "ckpt")
        size = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
        print(f"[J3] 2 optimizer steps (B=32, bf16 compute, dropout 0.1, "
              f"EMA 0.9999), losses {losses}; backbone tensors moved by the "
              f"steps {len(moved)} of {len(want)}, in every layer: "
              f"{layers_moved}; unmoved "
              f"{sorted(set(want) - moved)[:6]}; launches {launches}, "
              f"expected {expect}; "
              f"checkpoint {size / 1e9:.2f} GB; main() {wall:.1f} s")
        check(layers_moved, "J3 the backbone did not train")
        check(launches == expect, "J3 launch counts")
        check(all(bool(torch.isfinite(p).all())
                  for p in state.model.parameters()), "J3 weights")
        print(f"[J3] ms per optimizer step (host clock around each "
              f"synchronised step): {', '.join(f'{x:.1f}' for x in times)}; "
              f"D3's median at the hash encoder {d3_ms:.1f} (this run; "
              f"{card})")
        del state, want, bert
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase K

def moe_variant(model_cfg, state_dict, dev, compute, dtype, cf=None):
    """The flagship denoiser with ``moe_compute=compute`` (checked on every
    MoE layer), compute ``dtype`` (and ``cf`` as its capacity factor) on
    the same weights, on ``dev`` in eval mode."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    kw = {"moe_compute": compute, "dtype": dtype}
    if cf is not None:
        kw["moe_capacity_factor"] = cf
    with torch.device(dev):
        m = MotionTransformer(dataclasses.replace(model_cfg, **kw))
    m.load_state_dict(state_dict)
    check_moe_compute(m, compute, 4 * model_cfg.num_layers,
                      f"the {compute} denoiser")
    return m.eval()


def check_moe_compute(model, mode, n_layers, where):
    """Every MoE layer of ``model`` computes in ``mode``: a layer's compute
    is fixed when it is built, so a copy of a module built in another mode
    would not switch."""
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

    computes = [x.compute for x in model.modules()
                if isinstance(x, SwitchMoELayer)]
    check(len(computes) == n_layers and set(computes) == {mode},
          f"{where}: the MoE layers compute {sorted(set(computes))} "
          f"({len(computes)} layers), expected {mode} in {n_layers}")


def dispatch_drops(m, args, ids):
    """One forward of a ``dispatch`` denoiser with each MoE layer's routing
    captured: (its output, slots dropped, slots asked for, the most any
    layer dropped)."""
    import torch
    from motiondiffusion_moe_tpu_torch.models import moe as TM

    own, seen = TM.top_k_lowest_index, []

    def top_k(probs, k):
        vals, idx = own(probs, k)
        seen.append(idx)
        return vals, idx

    with patched((TM, "top_k_lowest_index", top_k)), torch.inference_mode():
        out = m(*args, text_ids=ids)
    cf, E = m.config.moe_capacity_factor, m.config.num_experts
    dropped = []
    for idx in seen:
        S, k = idx.shape
        keep = TM.capacity_slots(idx, E, TM.expert_capacity(S, E, cf))[1]
        dropped.append(S * k - int(keep.sum()))
    return out, sum(dropped), sum(i.numel() for i in seen), max(dropped)


K4_LAYERS = 1  # K4's blocks a scale (full width)


def phase_k(cfg, dev, card, c_timings):
    """The MoE dense and dispatch paths, visualize, serving_quality and
    profile_bench at the flagship's full width and depth (see the module
    doc)."""
    import torch

    t0 = time.perf_counter()
    seconds, mark = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now

    model = build_flagship(cfg)
    sd = model.state_dict()
    phase_k1(cfg, sd, dev, card, c_timings)
    lap("K1")
    phase_k2(cfg, sd, dev, card)
    lap("K2")
    with tempfile.TemporaryDirectory() as root:
        run = write_run_dir(root, cfg, model)
        del model
        phase_k3(run, sd, root, dev, card)
        lap("K3")
        # K4's 1,153 forwards wait on the host: at the full width, 2 blocks
        # a scale (with K4 at 8 the whole run passed 900 s on a slow host)
        cfg4 = dataclasses.replace(
            cfg, name=cfg.name + "_k4", model=dataclasses.replace(
                cfg.model, num_layers=K4_LAYERS))
        run4 = write_run_dir(root, cfg4, build_flagship(cfg4), tag="K4")
        phase_k4(run4, root, dev, card, 2 * 2 * K4_LAYERS)
        lap("K4")
        phase_k5(root, card)
        lap("K5")
    torch.cuda.empty_cache()
    print(f"[K] phase K in {time.perf_counter() - t0:.1f} s, by part "
          f"{seconds} ({card})")


def phase_k1(cfg, sd, dev, card, c_timings):
    """moe_compute dense and dispatch on the flagship's weights ``sd``:
    kernels vs plain by phase B's rule, dense vs dense_fused, dispatch at
    cf = E vs dense, the slots dispatch drops at cf = 2, then dpm20 through
    the pipeline with exact launch counts, s/motion and peak memory."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    args, ids = denoiser_inputs(cfg, dev)
    B, T, F = args[0].shape
    E = cfg.model.num_experts

    def fwd(m, kernels=True):
        m.set_use_kernels(kernels)
        with torch.inference_mode():
            out = m(*args, text_ids=ids)
        m.set_use_kernels(True)
        torch.cuda.synchronize()
        check(out.shape == (B, T, F) and bool(torch.isfinite(out).all()),
              f"K1 {m.config.moe_compute} output {tuple(out.shape)} or "
              "non-finite")
        return out

    ref32, out16 = {}, {}
    for mode in ("dense_fused", "dense", "dispatch"):
        m = moe_variant(cfg.model, sd, dev, mode, "float32")
        ref32[mode] = fwd(m, False)
        if mode != "dense_fused":
            rel = rel_rms(fwd(m), ref32[mode])
            ok = rel <= DENOISER_F32_REL_RMS
            print(f"[K1] moe_compute={mode} float32 compute B={B} T={T}: "
                  f"kernels vs use_kernels=False rel_rms={rel:.3e}; tol "
                  f"<= {DENOISER_F32_REL_RMS:g} -> {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 {mode} (float32) kernels vs plain")
        del m
        m = moe_variant(cfg.model, sd, dev, mode, "bfloat16")
        out16[mode] = fwd(m)
        if mode != "dense_fused":
            err_k = rel_rms(out16[mode], ref32[mode])
            err_p = rel_rms(fwd(m, False), ref32[mode])
            tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
            ok = err_k <= tol
            print(f"[K1] moe_compute={mode} bfloat16 compute: rel_rms to "
                  f"its f32 result: kernels {err_k:.3e}, use_kernels=False "
                  f"{err_p:.3e}; tol {tol:.3e} -> {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 {mode} (bfloat16) kernels vs plain")
        if mode == "dispatch":
            _, dropped, slots, most = dispatch_drops(m, args, ids)
            print(f"[K1] dispatch at capacity factor "
                  f"{cfg.model.moe_capacity_factor:g} (bf16, B={B}): "
                  f"{dropped} of {slots} (token, choice) slots dropped over "
                  f"{4 * cfg.model.num_layers} MoE calls, at most {most} "
                  "in one call")
        del m
        torch.cuda.empty_cache()

    rel = rel_rms(ref32["dense"], ref32["dense_fused"])
    ok = rel <= DENOISER_F32_REL_RMS
    print(f"[K1] dense vs dense_fused, float32 compute: rel_rms={rel:.3e}; "
          f"tol <= {DENOISER_F32_REL_RMS:g} -> {'ok' if ok else 'FAIL'}")
    check(ok, "K1 dense vs dense_fused (float32)")
    err_d = rel_rms(out16["dense"], ref32["dense"])
    err_f = rel_rms(out16["dense_fused"], ref32["dense_fused"])
    tol = DENOISER_BF16_FACTOR * err_f + DENOISER_BF16_FLOOR
    ok = err_d <= tol
    print(f"[K1] dense vs dense_fused, bfloat16 compute: rel_rms to the f32 "
          f"result dense {err_d:.3e}, dense_fused {err_f:.3e} (tol "
          f"{tol:.3e}); dense vs dense_fused directly "
          f"{rel_rms(out16['dense'], out16['dense_fused']):.3e} -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "K1 dense vs dense_fused (bfloat16)")
    for dtype in ("float32", "bfloat16"):
        m = moe_variant(cfg.model, sd, dev, "dispatch", dtype, cf=float(E))
        out, dropped, slots, _ = dispatch_drops(m, args, ids)
        del m
        check(out.shape == (B, T, F) and bool(torch.isfinite(out).all()),
              f"K1 dispatch at cf = E ({dtype}): {tuple(out.shape)} or "
              "non-finite")
        check(dropped == 0, f"K1 dispatch at cf = E dropped {dropped}")
        if dtype == "float32":
            # against dense's plain result
            rel = rel_rms(out, ref32["dense"])
            ok = rel <= DENOISER_F32_REL_RMS
            print(f"[K1] dispatch at cf = E = {E} (0 of {slots} slots "
                  f"dropped) vs dense, float32 compute, kernels: rel_rms="
                  f"{rel:.3e}; tol <= {DENOISER_F32_REL_RMS:g} -> "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "K1 dispatch without drops vs dense (float32)")
        else:
            # phase B's rule against dense: both held to dense's f32 result
            err_x = rel_rms(out, ref32["dense"])
            err_d = rel_rms(out16["dense"], ref32["dense"])
            tol = DENOISER_BF16_FACTOR * err_d + DENOISER_BF16_FLOOR
            ok = err_x <= tol
            print(f"[K1] dispatch at cf = E vs dense, bfloat16 compute, "
                  f"kernels: rel_rms to dense's f32 result dispatch "
                  f"{err_x:.3e}, dense {err_d:.3e} (tol {tol:.3e}); "
                  f"dispatch vs dense directly "
                  f"{rel_rms(out, out16['dense']):.3e} -> "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, "K1 dispatch without drops vs dense (bfloat16)")
    del ref32, out16
    torch.cuda.empty_cache()

    counted = (P.favor_qkv, P.performer_epilogue)
    prompts = [f"a person performs action number {i}" for i in range(16)]
    for mode in ("dense", "dispatch"):
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, moe_compute=mode))
        # the model built from mcfg, not a copy of a module of another mode
        pipe = GenerationPipeline(mcfg, params=sd, sampler="dpm",
                                  num_inference_steps=20, micro_batch=16,
                                  param_dtype="bfloat16", device=dev)
        check_moe_compute(pipe.model, mode, 4 * cfg.model.num_layers,
                          f"K1 the {mode} pipeline")
        pipe.generate(["warm up"], [T])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) / 2 ** 30
        for c in counted:
            c.launches = 0
        t0 = time.perf_counter()
        out = pipe.generate(prompts, [T] * 16,
                            generator=torch.Generator(dev).manual_seed(7))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        got = {c.__name__: c.launches for c in counted}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(all(np.isfinite(o).all() and o.shape == (T, F) for o in out),
              f"K1 {mode} dpm20 motions")
        want = 2 * 2 * cfg.model.num_layers * pipe.forwards_per_sample
        print(f"[K1] moe_compute={mode} dpm20 generate 16 prompts x {T} "
              f"frames (CFG, micro_batch 16, bf16 weights): {s:.3f} s, "
              f"{s / 16:.4f} s/motion (phase C's dense_fused "
              f"{c_timings['dpm20'] / 16:.4f}), peak {peak:.2f} GiB "
              f"allocated, {peak - base:.2f} GiB above the {base:.2f} GiB "
              f"live at its start; launches {got}, expected {want} each "
              f"({card})")
        check(all(n == want for n in got.values()),
              f"K1 {mode} launch counts")
        del pipe
        torch.cuda.empty_cache()


def phase_k2(cfg, sd, dev, card):
    """One train step (after a warm-up step) at B = 32, dropout 0.1, under
    dense and under dispatch, from the flagship's weights ``sd``: finite
    loss and grad norm, kernels 1 and 3 launched 32 times a step, peak
    memory, ms/step."""
    import torch
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    counted = (P.favor_qkv, P.favor_qkv_bwd)
    n_perf = 2 * 2 * cfg.model.num_layers
    for mode in ("dense", "dispatch"):
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, moe_compute=mode))
        m = moe_variant(cfg.model, sd, dev, mode, cfg.model.dtype)
        state = create_train_state(m, mcfg)
        step = TrainStep(make_schedule(
            schedule_name=mcfg.diffusion.beta_schedule,
            num_timesteps=mcfg.diffusion.num_timesteps, device=dev), mcfg)
        batch, _ = synthetic_batch(mcfg, dev)
        g = torch.Generator(dev).manual_seed(SEED + 30)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) / 2 ** 30
        for c in counted:
            c.launches = 0
        times, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            metrics = step(state, batch, g)
            loss, gn = (float(metrics[k]) for k in ("loss_total",
                                                     "grad_norm"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            check(math.isfinite(loss) and math.isfinite(gn),
                  f"K2 {mode}: loss {loss}, grad norm {gn}")
        got = {c.__name__: c.launches for c in counted}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"[K2] moe_compute={mode} train step B=32, bf16 compute, "
              f"dropout 0.1: losses {losses}, last grad norm {gn:.4g}; "
              f"launches {got}, expected {n_perf} x 2 each; ms per step "
              f"(host clock, synchronised): first {times[0]:.1f}, then "
              f"{times[1]:.1f}; peak {peak:.2f} GiB allocated, "
              f"{peak - base:.2f} GiB above the {base:.2f} GiB live at its "
              f"start ({card})")
        check(all(n == n_perf * 2 for n in got.values()),
              f"K2 {mode} launch counts")
        check(all(bool(torch.isfinite(p).all()) for p in m.parameters()),
              f"K2 {mode}: non-finite parameters")
        del state, m, step
        torch.cuda.empty_cache()


def write_run_dir(root, cfg, model, tag="K3"):
    """A run dir of the flagship as the port's tools/train.py writes one:
    config.json, ckpt/step_0.pt through CheckpointManager, and meta/ with a
    seeded normalizer of a motion's scale (joints within the plot's box)."""
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    t0 = time.perf_counter()
    run = os.path.join(root, cfg.name)
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.json"))
    CheckpointManager(os.path.join(run, "ckpt")).save(
        0, create_train_state(model, cfg), epoch=0)
    rng = np.random.default_rng(SEED + 40)
    F = cfg.data.dim_pose
    mean = (0.05 * rng.standard_normal(F)).astype(np.float32)
    mean[3] = 1.0
    std = (0.05 + 0.1 * rng.random(F)).astype(np.float32)
    MotionNormalizer(mean, std).save(os.path.join(run, "meta"))
    size = sum(os.path.getsize(os.path.join(run, "ckpt", f))
               for f in os.listdir(os.path.join(run, "ckpt")))
    print(f"[{tag}] run dir written: {size / 1e9:.2f} GB checkpoint in "
          f"{time.perf_counter() - t0:.1f} s")
    return run


def gif_frames(path):
    """(frames stored, total duration in ms) of a GIF."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        ms = sum(f.info.get("duration", 0) for f in ImageSequence.Iterator(im))
        return im.n_frames, ms


def phase_k3(run, sd, root, dev, card):
    """tools/visualize.py on the card: a 120-frame GIF, joints [120, 22, 3]
    finite and equal bit for bit to an in-process pipeline on the weights
    ``sd`` that the run dir holds -> recover_from_ric -> filter from the
    same seed."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.motion import recover_from_ric
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools import visualize
    from motiondiffusion_moe_tpu_torch.utils import plot

    text, n, seed = "a person walks forward and waves", 120, 5
    gif, npy = os.path.join(root, "k3.gif"), os.path.join(root, "k3.npy")
    counted = (P.favor_qkv, P.performer_epilogue)
    for c in counted:
        c.launches = 0
    render = plot.plot_3d_motion
    render_s = []

    def timed_render(*a, **k):
        t = time.perf_counter()
        render(*a, **k)
        render_s.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    with patched((plot, "plot_3d_motion", timed_render)):
        visualize.main(["--run_dir", run, "--text", text, "--sampler", "dpm",
                        "--motion_length", str(n), "--seed", str(seed),
                        "--npy_path", npy, "--result_path", gif,
                        "--device", str(dev)])
    s = time.perf_counter() - t0
    got = {c.__name__: c.launches for c in counted}
    joints = np.load(npy)
    check(os.path.exists(gif), "K3: no GIF")
    frames, ms = gif_frames(gif)
    # Pillow stores a run of equal frames once, with their summed duration
    check(ms == n * 50, f"K3: the GIF holds {ms} ms, expected {n} frames "
                        "at 20 fps")
    check(joints.shape == (n, 22, 3) and np.isfinite(joints).all(),
          f"K3 joints {joints.shape} or non-finite")
    cfg = ExperimentConfig.load(os.path.join(run, "config.json"))
    normalizer = MotionNormalizer.load(os.path.join(run, "meta"))
    pipe = GenerationPipeline(cfg, params=sd, sampler="dpm", micro_batch=1,
                              device=dev)
    motion = normalizer.denormalize_np(pipe.generate(
        [text], [n], generator=torch.Generator(dev).manual_seed(seed))[0])
    want = plot.motion_temporal_filter(recover_from_ric(
        torch.from_numpy(motion).to(dev), cfg.data.num_joints).cpu().numpy(),
        sigma=1.0)
    same = np.array_equal(joints, want)
    print(f"[K3] tools/visualize.py --sampler dpm --motion_length {n}: "
          f"{s:.1f} s ({render_s[0]:.1f} s of it drawing the GIF), GIF "
          f"{n} frames at 20 fps ({frames} distinct), joints "
          f"{joints.shape} finite, bit for bit equal to the in-process "
          f"pipeline: {same}; launches {got} "
          f"({pipe.forwards_per_sample} forwards x 32) ({card})")
    check(same, "K3 joints differ from the in-process pipeline")
    check(all(v == 32 * pipe.forwards_per_sample for v in got.values()),
          "K3 launch counts")
    del pipe


def phase_k4(run, root, dev, card, n_perf):
    """tools/serving_quality.py on the card with a seeded finest.tar: its
    table finite, kernels 1 and 2 launched ``n_perf`` x forwards (2 per
    block), seconds."""
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.tools import serving_quality

    finest = os.path.join(root, "finest.tar")
    write_finest_tar(finest)
    counted = (P.favor_qkv, P.performer_epilogue)
    for c in counted:
        c.launches = 0
    t0 = time.perf_counter()
    res = serving_quality.main(["--run_dir", run, "--batch", "8",
                                "--evaluator_ckpt", finest,
                                "--device", str(dev)])
    s = time.perf_counter() - t0
    got = {c.__name__: c.launches for c in counted}
    # ddim at the full 1000-step schedule, ddim50 twice, dpm20 twice, dpm10
    forwards = 1000 + 2 * 50 + 2 * 21 + 11
    values = [v for pair in res["stats"].values() for v in pair] + list(
        res["drifts"].values())
    print(f"[K4] tools/serving_quality.py --batch 8 (finest.tar seeded): "
          f"{s:.1f} s in all; per variant (s) "
          f"{ {k: round(v, 2) for k, v in res['seconds'].items()} }; "
          f"launches {got}, expected {n_perf} x {forwards} each ({card})")
    check(len(values) == 12 and all(math.isfinite(v) for v in values),
          "K4 table")
    check(set(res["drifts"]) == {"ddim50", "dpm20"}, "K4 bf16 drift lines")
    check(all(v == n_perf * forwards for v in got.values()),
          "K4 launch counts")


def phase_k5(root, card):
    """tools/profile_bench.py --mode sample (5 ddim steps, B = 16) and
    --mode train (B = 8): the family table's total within 10 % of the
    profiler's device total, the rows of the path's kernels present.
    torch.profiler now and then records nothing or loses kernels, so a
    reading that fails is taken again, up to three times."""
    from motiondiffusion_moe_tpu_torch.tools import profile_bench

    for argv, want in (
            (["--mode", "sample", "--steps", "5", "--batch", "16"],
             ("favor_qkv (1; 8, 10)", "performer_epilogue (2)")),
            (["--mode", "train", "--batch", "8"],
             ("favor_qkv (1; 8, 10)", "favor_qkv_bwd (3)"))):
        for attempt in range(3):
            t0 = time.perf_counter()
            res = profile_bench.main(argv + [
                "--top", "12", "--device", "cuda",
                "--log_dir", tempfile.mkdtemp(dir=root)])
            s = time.perf_counter() - t0
            a, total = res["analysis"], res["profiler_device_ms"]
            ok = (a is not None and bool(total)
                  and abs(a["total_ms"] - total) <= 0.1 * total
                  and all(f in a["families"] for f in want))
            if a is not None and total:
                shares = {k: round(100 * v[1] / a["total_ms"], 1)
                          for k, v in sorted(a["families"].items(),
                                             key=lambda kv: -kv[1][1])}
                print(f"[K5] profile_bench {' '.join(argv)} (reading "
                      f"{attempt + 1}): {s:.1f} s; family table "
                      f"{a['total_ms']:.3f} ms vs the profiler's device "
                      f"total {total:.3f} ms; shares (%) {shares} -> "
                      f"{'ok' if ok else 'FAIL'} ({card})")
            else:
                print(f"[K5] profile_bench {' '.join(argv)} (reading "
                      f"{attempt + 1}): the profiler recorded no kernels")
            if ok:
                break
        check(ok, f"K5 {argv[1]}: the family table's total within 10 % of "
                  f"the profiler's and the rows {want}")


# ---------------------------------------------------------------------------
# L: a JAX run's orbax checkpoint, read, resumed, served and written
# ---------------------------------------------------------------------------

L_LAYERS = 1  # L2's blocks a scale (full width)
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "fixtures", "jax_orbax_run")


def phase_l(cfg, dev, card):
    """A JAX run's orbax checkpoint on the card machine (see the module
    doc): L1 the committed OCDBT fixture, L2 the flagship through the JAX
    layout."""
    import torch

    t0 = time.perf_counter()
    phase_l1(card)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        phase_l2(cfg, root, dev, card)
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"[L] phase L in {now - t0:.1f} s (L1 {t1 - t0:.1f} s, L2 "
          f"{now - t1:.1f} s) ({card})")


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape holding the same bytes."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.is_floating_point():
        a, b = (x.contiguous().view({2: torch.int16, 4: torch.int32,
                                     8: torch.int64}[x.element_size()])
                for x in (a, b))
    return torch.equal(a, b)


def nested(flat: dict) -> dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def phase_l1(card):
    """The committed fixture, written by the JAX package's CheckpointManager
    (OCDBT, zstd chunks): every leaf, the step and the epoch against its
    .npz bit for bit, and the port's payload (CheckpointManager.read,
    load_run) against the bridge of those leaves. Its width has no kernel
    instance: no kernel runs here."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.models.bridge import (
        jax_to_state_dict)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.tools.export import load_run
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.utils import zstd
    from motiondiffusion_moe_tpu_torch.utils.orbax_format import (
        flatten, read_step)

    npz = np.load(ORBAX_FIXTURE + ".npz")
    bf16 = set(npz["__bf16__"].tolist())
    want = {k: (torch.from_numpy(npz[k]).view(torch.bfloat16) if k in bf16
                else torch.from_numpy(npz[k]))
            for k in npz.files if k != "__bf16__"}
    ckpt = os.path.join(ORBAX_FIXTURE, "ckpt")
    step = max(int(n) for n in os.listdir(ckpt) if n.isdigit())
    print(f"[L1] libzstd {zstd.library_path()} version {zstd.version()}")
    t0 = time.perf_counter()
    got = {".".join(k for k, _ in p): v for p, v in
           flatten(read_step(os.path.join(ckpt, str(step))))
           if v is not None}
    t_read = time.perf_counter() - t0
    check(set(got) == set(want), f"L1: leaves {sorted(set(got) ^ set(want))}")
    bad = [k for k in want if not same_bits(got[k], want[k])]
    nbytes = sum(v.numel() * v.element_size() for v in got.values())
    print(f"[L1] {ckpt}/{step} (OCDBT, zstd) read in {t_read:.3f} s: "
          f"{len(got)} leaves, {nbytes} bytes, {len(bf16)} of them bf16; "
          f"{len(bad)} differ from the .npz {bad[:3]}; step "
          f"{int(got['step'])}, epoch {int(got['epoch'])}")
    check(not bad, "L1: leaves differ from the fixture's .npz")

    cfg = ExperimentConfig.load(os.path.join(ORBAX_FIXTURE, "config.json"))
    payload = CheckpointManager(ckpt, cfg=cfg).read()
    with torch.device("meta"):
        named = list(MotionTransformer(cfg.model,
                                       use_kernels=False).named_parameters())
    trainable = [n for n, p in named if p.requires_grad]
    tree = nested(want)
    adam = tree["opt_state"]["1"]["0"]
    ref = {"params": jax_to_state_dict(tree["params"]["params"]),
           "mu": jax_to_state_dict(adam["mu"]["params"]),
           "nu": jax_to_state_dict(adam["nu"]["params"]),
           "ema": jax_to_state_dict(tree["ema_params"]["params"])}
    checks = {
        "params": all(same_bits(payload["params"][n], ref["params"][n])
                      for n, _ in named)
        and len(payload["params"]) == len(named),
        "mu": all(same_bits(m, ref["mu"][n]) for n, m in
                  zip(trainable, payload["opt_state"]["mu"])),
        "nu": all(same_bits(v, ref["nu"][n]) for n, v in
                  zip(trainable, payload["opt_state"]["nu"])),
        "ema": all(same_bits(e, ref["ema"][n]) for (n, _), e in
                   zip(named, payload["ema_params"]["params"])),
        "count": payload["opt_state"]["count"] == int(adam["count"])
        == int(tree["opt_state"]["1"]["1"]["count"]),
        "step": payload["step"] == int(want["step"]) == step,
        "epoch": payload["epoch"] == int(want["epoch"]),
        "rng": payload["rng"] is None,
    }
    _, sd, run_step, normalizer = load_run(ORBAX_FIXTURE, use_ema=True)
    checks["load_run"] = (run_step == step and normalizer is not None
                          and all(same_bits(sd[n], ref["ema"][n])
                                  for n, _ in named))
    mu_dtypes = sorted({str(m.dtype) for m in payload["opt_state"]["mu"]})
    print(f"[L1] CheckpointManager.read and load_run(use_ema=True) against "
          f"the bridge of the .npz leaves: {checks}; {len(named)} "
          f"parameters, {len(trainable)} with moments (mu {mu_dtypes}), "
          f"count {payload['opt_state']['count']} ({card})")
    check(all(checks.values()), f"L1: the port's payload {checks}")


def l2_losses(trainer):
    """Record (loss, grad norm) of every step ``trainer`` takes."""
    seen = []
    step = trainer.train_step

    def recorded(state, batch, generator):
        metrics = step(state, batch, generator)
        seen.append((metrics["loss_total"].item(),
                     metrics["grad_norm"].item()))
        return metrics

    trainer.train_step = recorded
    return seen


def phase_l2(cfg, root, dev, card):
    """The flagship (moe_small, bf16 compute, EMA, a warmup schedule) for 2
    train steps at B = 32, dropout 0.1, saved in the JAX layout: the round
    trip bit for bit, a served dpm20 micro-batch from load_run(use_ema)
    against the in-memory EMA, and the trainer resuming for 2 more steps
    against the in-memory state continued with the same generator."""
    import torch
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.loader import DataLoader
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.export import load_run
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer
    from motiondiffusion_moe_tpu_torch.utils import orbax_format

    cfgL = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_layers=L_LAYERS),
        train=dataclasses.replace(cfg.train, ema_decay=0.999,
                                  lr_warmup_steps=100, num_epochs=1))
    check(cfgL.model.dropout > 0 and cfgL.train.uncond_step,
          "L2 trains at dropout > 0 with the uncond double step")
    run = os.path.join(root, cfgL.name)
    os.makedirs(run)
    cfgL.save(os.path.join(run, "config.json"))
    MotionNormalizer.identity(cfgL.data.dim_pose).save(
        os.path.join(run, "meta"))
    ckpt = os.path.join(run, "ckpt")

    t0 = time.perf_counter()
    model = build_flagship(cfgL).to(dev)
    state = create_train_state(model, cfgL)
    trainer = Trainer(cfgL, model=model, device=dev)
    loader = DataLoader(SyntheticText2MotionDataset(cfgL.data, size=32,
                                                    seed=SEED + 50),
                        batch_size=32, seed=SEED + 50)
    gen = torch.Generator(dev).manual_seed(SEED + 51)
    state = trainer.fit(state, loader, generator=gen)
    torch.cuda.synchronize()
    check(state.step == 2, f"L2: {state.step} steps, expected 2")
    print(f"[L2] flagship moe_small at {L_LAYERS} blocks a scale, bf16 "
          f"compute, ema_decay 0.999, warmup "
          f"100: 2 train steps at B=32, dropout {cfgL.model.dropout} in "
          f"{time.perf_counter() - t0:.1f} s")

    # save in the JAX layout; the seconds inside the file layer
    # (write_step, read_step) counted apart from the tree's conversion (the
    # bridge, device <-> host)
    gen_state = gen.get_state()
    mgr = CheckpointManager(ckpt, fmt="orbax", cfg=cfgL)
    inner = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                inner[name] = time.perf_counter() - t
        return run

    t0 = time.perf_counter()
    with patched((orbax_format, "write_step",
                  timed("write_step", orbax_format.write_step))):
        mgr.save(state.step, state, 1, gen)
    t_write = time.perf_counter() - t0
    step_dir = os.path.join(ckpt, str(state.step))
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(step_dir) for f in fs)
    with open(os.path.join(step_dir, "default", "_METADATA")) as f:
        jax_layout = '"use_ocdbt": false' in f.read()

    # the trainer resumes from the saved step; its restore's read is the
    # round trip's, held against the in-memory state at step 2. Its
    # end-of-epoch save (step 4) is recorded, not written: the step 2 save
    # above went through the same path.
    cfg2 = dataclasses.replace(cfgL, train=dataclasses.replace(
        cfgL.train, num_epochs=2))
    model_b = MotionTransformer(cfg2.model).to(dev)
    state_b = create_train_state(model_b, cfg2)
    trainer_b = Trainer(cfg2, model=model_b, device=dev)
    seen_b = l2_losses(trainer_b)
    mgr_b = CheckpointManager(ckpt, cfg=cfg2)
    got, saved = {}, []
    mgr_b.read = timed("read", lambda *a, **k: got.setdefault(
        "payload", CheckpointManager.read(mgr_b, *a, **k)))
    mgr_b.save = lambda step, *a, **k: saved.append(step)
    P.favor_qkv_bwd.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with patched((orbax_format, "read_step",
                  timed("read_step", orbax_format.read_step))), \
            contextlib.redirect_stdout(out):
        state_b = trainer_b.fit(state_b, loader,
                                generator=torch.Generator(dev),
                                checkpoints=mgr_b)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    bwd = P.favor_qkv_bwd.launches
    t_read = inner["read"]
    payload = got.pop("payload")
    opt = state.optimizer
    named = list(state.model.named_parameters())
    checks = {
        "params": all(same_bits(payload["params"][n], p)
                      for n, p in named),
        "mu": all(same_bits(a, b) for a, b in
                  zip(payload["opt_state"]["mu"], opt.mu)),
        "nu": all(same_bits(a, b) for a, b in
                  zip(payload["opt_state"]["nu"], opt.nu)),
        "count": payload["opt_state"]["count"] == opt.count == 2,
        "ema": all(same_bits(a, b) for a, b in
                   zip(payload["ema_params"]["params"], state.ema.params)),
        "step": payload["step"] == 2, "epoch": payload["epoch"] == 1,
        "rng": torch.equal(payload["rng"], gen_state),
    }
    del payload
    print(f"[L2] saved in the JAX layout (plain zarr, uncompressed: "
          f"{jax_layout}): {nbytes} bytes in {t_write:.2f} s "
          f"({nbytes / t_write / 1e9:.3f} GB/s; write_step "
          f"{inner['write_step']:.2f} s, the tree "
          f"{t_write - inner['write_step']:.2f} s); read back by the "
          f"trainer's restore (CheckpointManager.read) in {t_read:.2f} s "
          f"({nbytes / t_read / 1e9:.3f} GB/s; read_step "
          f"{inner['read_step']:.2f} s, the bridge "
          f"{t_read - inner['read_step']:.2f} s); bit for bit {checks} "
          f"(host; {card})")
    check(jax_layout, "L2: the saved step is not in the plain JAX layout")
    check(all(checks.values()), f"L2 round trip {checks}")

    # serve the saved EMA against the in-memory one
    texts = [f"a person walks forward and turns {i}" for i in range(16)]
    lens = [cfgL.model.max_frames] * 16
    kw = dict(sampler="dpm", num_inference_steps=20, micro_batch=16,
              device=dev)
    t0 = time.perf_counter()
    run_cfg, sd, run_step, _ = load_run(run, use_ema=True)
    pipe = GenerationPipeline(run_cfg, params=sd, **kw)
    del sd
    print(f"[L2] load_run(use_ema=True) step {run_step} + "
          f"GenerationPipeline onto the card: {time.perf_counter() - t0:.2f}"
          f" s")
    samples = []
    sample = pipe.sample
    pipe.sample = lambda *a, **k: samples.append(1) or sample(*a, **k)
    kern = (P.favor_qkv, P.performer_epilogue)
    for c in kern:
        c.launches = 0
    t0 = time.perf_counter()
    served = pipe.generate(texts, lens, generator=torch.Generator(
        dev).manual_seed(SEED + 52))
    torch.cuda.synchronize()
    s_motion = (time.perf_counter() - t0) / len(texts)
    launches = {c.__name__: c.launches for c in kern}
    fwd = len(samples) * pipe.forwards_per_sample
    n_perf = 2 * 2 * cfgL.model.num_layers
    pipe.sample = sample
    del pipe
    names = [n for n, _ in named]
    ref = GenerationPipeline(cfgL, params=dict(zip(names, state.ema.params)),
                             **kw)
    want = ref.generate(texts, lens, generator=torch.Generator(
        dev).manual_seed(SEED + 52))
    del ref
    same = all(np.array_equal(a, b) for a, b in zip(served, want))
    print(f"[L2] dpm20, 16 prompts x {lens[0]} frames (CFG micro-batch 16) "
          f"from the saved EMA vs the in-memory EMA, same seed: "
          f"{'bit-identical' if same else 'DIFFER'}; {fwd} forwards, "
          f"launches {launches}, expected {n_perf} x {fwd} each; "
          f"{s_motion:.4f} s/motion, the pipeline's first call ({card})")
    check(same, "L2: the served EMA is not the in-memory EMA's")
    check(all(v == n_perf * fwd for v in launches.values()),
          f"L2 serving launches {launches}")

    # the in-memory state continued with the same generator
    trainer_a = Trainer(cfg2, model=state.model, device=dev)
    seen_a = l2_losses(trainer_a)
    gen_a = torch.Generator(dev)
    gen_a.set_state(gen_state)
    state = trainer_a.fit(state, loader, generator=gen_a, start_epoch=1)
    print("".join(f"[L2] | {line}\n" for line in
                  out.getvalue().splitlines() if "[trainer]" in line),
          end="")
    exact = seen_a == seen_b and all(
        same_bits(a, b) for a, b in zip(state.model.parameters(),
                                        state_b.model.parameters()))
    rel = max(abs(a - b) / max(abs(b), 1e-12) for pa, pb in
              zip(seen_a, seen_b) for a, b in zip(pa, pb)) if \
        len(seen_a) == len(seen_b) == 2 else math.inf
    agree = ("bit for bit, parameters too" if exact else
             f"not bit for bit, max rel {rel:.3e} (tol "
             f"{DENOISER_BF16_FLOOR:g}, phase B's floor)")
    print(f"[L2] resumed by Trainer.fit from the JAX-layout step 2: steps "
          f"{state_b.step}; (loss, grad norm) resumed {seen_b} vs in-memory "
          f"{seen_a}: {agree}; favor_qkv_bwd launched {bwd}, expected "
          f"{n_perf} x 2; {t_resume:.1f} s with the restore; saves asked "
          f"of the {mgr_b.format}-format manager: steps {saved} ({card})")
    check(state_b.step == 4 and saved == [4] and mgr_b.format == "orbax",
          "L2: the resumed run's steps and its end-of-epoch save")
    check(exact or rel <= DENOISER_BF16_FLOOR,
          "L2: the resumed steps against the in-memory ones")
    check(bwd == n_perf * 2, f"L2: favor_qkv_bwd launched {bwd}")
    del state, state_b, trainer, trainer_a, trainer_b, model, model_b



# ---------------------------------------------------------------------------
# M: data-parallel training and ZeRO-1 over torch.distributed
# ---------------------------------------------------------------------------

M_B, M_LONG, M_SHORT = 32, (150, 196), (40, 100)  # rank 0 long, rank 1 short
M_LAYERS = 1   # M1's blocks a scale (full width)
M2_LAYERS = 2  # M2's blocks a scale (full width)
M_KERNELS = ("favor_qkv", "performer_epilogue", "favor_qkv_bwd",
             "performer_epilogue_bwd")


def m_config(cfg, dtype="float32"):
    """The flagship at dropout 0, no stochastic depth, EMA 0.999, in
    ``dtype`` compute."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=dtype, dropout=0.0,
                                       stochastic_depth_min=1.0),
        train=dataclasses.replace(cfg.train, ema_decay=0.999))


def m_batch(cfg, path):
    """The global batch of M1 and its noise, in rank order (rank r's rows
    ``[r * B / 2, (r + 1) * B / 2)``): ragged lengths, long on rank 0 and
    short on rank 1, seeded t and importance weights; saved to ``path``."""
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)

    rng = np.random.default_rng(SEED + 60)
    T, F, h = cfg.model.max_frames, cfg.model.input_feats, M_B // 2
    prompts = [f"a person walks forward and turns {i}" if i % 4 else ""
               for i in range(M_B)]
    np.savez(path,
             motion=rng.standard_normal((M_B, T, F)).astype(np.float32),
             length=np.concatenate([rng.integers(*M_LONG, h),
                                    rng.integers(*M_SHORT, h)]),
             text_ids=hash_tokenize(prompts, cfg.model.text_max_tokens),
             t=rng.integers(0, cfg.diffusion.num_timesteps, M_B),
             t_weight=rng.uniform(0.5, 2.0, M_B).astype(np.float32),
             noise=rng.standard_normal((M_B, T, F)).astype(np.float32))


def m_rows(path, dev, rows=slice(None)):
    import torch

    a = np.load(path)
    batch = {k: torch.from_numpy(a[k][rows]).to(dev) for k in
             ("motion", "length", "text_ids", "t", "t_weight")}
    for k in ("length", "text_ids", "t"):
        batch[k] = batch[k].long()
    return batch, torch.from_numpy(a["noise"][rows]).to(dev)


def m_step(cfg, weights, batch_path, dev, dp=None, steps=1):
    """``steps`` optimizer steps of the flagship from ``weights`` (a state
    dict) on this rank's rows (all of them without ``dp``); returns the
    state, the
    metrics of the last step, this rank's gradient of the first (copied to
    the host, outside the timed step, so the card's peak is the step's
    own), the kernels' launches per step and the ms of each step."""
    import torch
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.distributed import barrier
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    with torch.device(dev):
        model = MotionTransformer(cfg.model)
    model.load_state_dict(weights)
    model.to(dev)
    state = create_train_state(model, cfg, dp=dp)
    dc = cfg.diffusion
    step = TrainStep(make_schedule(schedule_name=dc.beta_schedule,
                                   num_timesteps=dc.num_timesteps,
                                   device=dev), cfg, dp=dp)
    h = M_B // (dp.world if dp is not None else 1)
    r = dp.rank if dp is not None else 0
    batch, noise = m_rows(batch_path, dev, slice(r * h, (r + 1) * h))
    counted = [getattr(P, k) for k in M_KERNELS]
    launches, times, grads = [], [], None
    for i in range(steps):
        for c in counted:
            c.launches = 0
        torch.cuda.synchronize()
        if dp is not None:
            barrier()  # the ranks start the step together
        t0 = time.perf_counter()
        metrics = step.backward(state, batch, None, noise=noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i == 0:
            grads = [p.grad.to("cpu", copy=True) if p.grad is not None
                     else torch.zeros(p.shape, dtype=p.dtype)
                     for p in model.parameters()]
        t0 = time.perf_counter()
        metrics = step.apply_update(state, metrics)
        torch.cuda.synchronize()
        times.append(ms + (time.perf_counter() - t0) * 1e3)
        launches.append({c.__name__: c.launches for c in counted})
    return state, metrics, grads, launches, times


def m_mean_grads(dp, grads, dev):
    """The first step's gradients (host copies) averaged over the ranks, on
    ``dev``, for the comparison alone (after the timed steps), and the ms
    of the one all-reduce of the whole flat gradient that takes."""
    import torch

    flat = torch.cat([g.reshape(-1) for g in grads]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp.sum_(flat).div_(dp.world)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return [v.view(g.shape) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)], ms


def m_whole(state, dev):
    """(parameters, mu, nu, EMA) as whole lists on ``dev`` (a collective
    under ZeRO-1, whose moments and EMA only rank 0 receives: None on the
    others)."""
    opt = state.optimizer.state_dict()
    ema = state.ema.state_dict()["params"]

    def on(ts):
        return None if ts is None else [t.to(dev) for t in ts]

    return ([p.detach() for p in state.model.parameters()], on(opt["mu"]),
            on(opt["nu"]), on(ema))


def m_resident(state) -> dict:
    """This rank's elements and bytes of the moments and the EMA, and what
    ZeRO-1 allows: a moment at most ceil(n / W) plus the flat buffers'
    alignment gaps, the EMA ceil(n / W)."""
    from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
        ALIGN_BYTES)

    opt, ema = state.optimizer, state.ema.params
    n = {"mu": sum(x.numel() for x in opt.mu),
         "nu": sum(x.numel() for x in opt.nu),
         "ema": sum(x.numel() for x in ema)}
    nbytes = sum(x.numel() * x.element_size()
                 for x in list(opt.mu) + list(opt.nu) + list(ema))
    world = opt.dp.world if opt.dp is not None else 1
    gaps = ALIGN_BYTES // 4 * (len(opt.params) + world)  # f32 parameters
    trainable = sum(p.numel() for p in opt.params)
    every = sum(p.numel() for p in state.model.parameters())
    return {**n, "bytes": nbytes, "trainable": trainable, "all": every,
            "shard_max": -(-(trainable + gaps) // world),
            "ema_shard": -(-every // world)}


def rel_rms_rule(pairs, factor=1):
    """(worst error over tolerance, its index) of D2's rule for the same f32
    math in another order: each tensor's RMS error relative to its RMS,
    floored at 1e-3 of the RMS of all, within factor x STEP_GRAD_REL_RMS
    (the flagship's sums over 6,272 tokens cancel, so an entry's error is
    no fixed share of the largest entry)."""
    import torch

    pairs = list(pairs)
    floor = 1e-3 * torch.sqrt(torch.stack(
        [b.float().pow(2).mean() for _, b in pairs]).mean())
    errs = [float((a - b).float().pow(2).mean().sqrt() / torch.maximum(
        b.float().pow(2).mean().sqrt(), floor))
        / (factor * STEP_GRAD_REL_RMS) for a, b in pairs]
    i = int(np.argmax(errs))
    return errs[i], i


def step_rule(pairs, ref_grads, lr):
    """(worst error over tolerance, its index): a parameter after Adam's
    first update within 2e-6 where its gradient is at least 1e-6, within 2
    lr elsewhere (the update moves each by lr g / (|g| + eps))."""
    import torch

    errs = []
    for i, (a, b) in enumerate(pairs):
        tol = torch.where(ref_grads[i].abs() >= 1e-6,
                          torch.full_like(b, 2e-6),
                          torch.full_like(b, 2 * lr))
        errs.append(float(((a - b).abs() / tol).max()))
    i = int(np.argmax(errs))
    return errs[i], i


def m_compare(got, ref, grads, ref_grads, lr, names, tnames) -> dict:
    """{part: (worst error over tolerance, the parameter)}, <= 1
    passing: the gradient, mu and nu by :func:`rel_rms_rule` (twice the
    tolerance for nu, a square), a parameter and the EMA after the update
    by :func:`step_rule`."""
    out = {"grads": rel_rms_rule(zip(grads, ref_grads)),
           "params": step_rule(zip(got[0], ref[0]), ref_grads, lr),
           "ema": step_rule(zip(got[3], ref[3]), ref_grads, lr),
           "mu": rel_rms_rule(zip(got[1], ref[1])),
           "nu": rel_rms_rule(zip(got[2], ref[2]), 2)}
    named = {}
    for part, (err, i) in out.items():
        who = tnames[i] if part in ("mu", "nu") else names[i]
        named[part] = (round(err, 4), who)
    # the largest entry error over the largest entry, shown beside
    named["grads, max over largest"] = round(max(
        float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        for a, b in zip(grads, ref_grads)), 8)
    return named


def m_worst(errs) -> float:
    return max(v[0] for k, v in errs.items() if isinstance(v, tuple))


def phase_m(cfg, dev, card):
    """Data-parallel training and ZeRO-1 (see the module doc): M1 the step
    at full width, one rank over NCCL and two ranks on this card over
    gloo, against the one-process step."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        phase_m1(cfg, dev, card, root)
    torch.cuda.empty_cache()
    print(f"[M] phase M in {time.perf_counter() - t0:.1f} s ({card})")


def phase_m1(cfg, dev, card, root):
    import torch
    import torch.distributed as dist
    from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
        DataGroup)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)

    j = os.path.join
    cfg32 = m_config(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_layers=M_LAYERS)))
    params_path, batch_path = j(root, "m_params.pt"), j(root, "m_batch.npz")
    t0 = time.perf_counter()
    weights = build_flagship(cfg32).state_dict()
    t_init = time.perf_counter() - t0
    torch.save(weights, params_path)
    weights = {k: v.to(dev) for k, v in weights.items()}
    m_batch(cfg32, batch_path)
    lr = cfg32.train.lr
    print(f"[M1] the flagship's seeded weights in {t_init:.1f} s, saved for "
          f"the ranks in {time.perf_counter() - t0 - t_init:.1f} s")

    # (i) one rank over NCCL, through parallel/, against the plain step
    t0 = time.perf_counter()
    ref_state, ref_m, ref_g, _, _ = m_step(cfg32, weights, batch_path,
                                           dev)
    ref_g = [g.to(dev) for g in ref_g]
    names = ([n for n, _ in ref_state.model.named_parameters()],
             [n for n, p in ref_state.model.named_parameters()
              if p.requires_grad])
    ref = m_whole(ref_state, dev)
    del ref_state
    initialize_distributed(f"file://{j(root, 'rdv_m1')}", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"M1 (i) backend {backend}, not nccl")
        dp = DataGroup()
        for zero1 in (False, True):
            c = dataclasses.replace(cfg32, parallel=dataclasses.replace(
                cfg32.parallel, zero1=zero1))
            state, m, g, launches, times = m_step(c, weights, batch_path,
                                                  dev, dp)
            g, _ = m_mean_grads(dp, g, dev)
            got = m_whole(state, dev)
            del state
            if not zero1:
                bits = {"loss": same_bits(m["loss_total"],
                                          ref_m["loss_total"]),
                        "grad_norm": same_bits(m["grad_norm"],
                                               ref_m["grad_norm"])}
                for name, k in (("params", 0), ("mu", 1), ("nu", 2),
                                ("ema", 3)):
                    bits[name] = all(
                        a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(got[k], ref[k]))
                ok = all(bits.values())
                print(f"[M1] (i) world 1 over {backend}, zero1 off, B = "
                      f"{M_B}, f32: the step through parallel/ against the "
                      f"plain TrainStep, bit for bit: {bits}; launches "
                      f"{launches[0]}; {times[0]:.1f} ms ({card}) -> "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"M1 (i) bits {bits}")
            else:
                errs = m_compare(got, ref, g, ref_g, lr, *names)
                rel = {k: abs(float(m[k]) - float(ref_m[k]))
                       / abs(float(ref_m[k]))
                       for k in ("loss_total", "grad_norm")}
                ok = (m_worst(errs) <= 1 and rel["loss_total"] == 0
                      and rel["grad_norm"] <= STEP_LOSS_REL)
                print(f"[M1] (i) world 1 over {backend}, zero1 on (the "
                      f"flat shard is the whole; reduce_scatter_tensor and "
                      f"all_gather_into_tensor over {backend}): loss rel "
                      f"{rel['loss_total']:.1e} (bits wanted), grad_norm "
                      f"rel {rel['grad_norm']:.1e} (the flat norm sums in "
                      f"another order; tol {STEP_LOSS_REL:g}), worst error "
                      f"over tolerance {errs}; {times[0]:.1f} ms -> "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"M1 (i) zero1 {errs} {rel}")
            del got, g  # not alive in the next case's measured step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del ref, ref_g, weights
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    # (ii) two ranks on this one card: NCCL refuses two ranks on one device
    # ("Duplicate GPU detected", as of NCCL 2.28.9), so gloo is
    # named here, with CUDA tensors staged through the host
    spec = {"init": f"file://{j(root, 'rdv_m1_2')}", "params": params_path,
            "batch": batch_path, "out": root, "cfg": cfg32.to_dict(),
            "device": str(dev), "world": 2, "backend": "gloo",
            "label": "two ranks sharing one card, collectives staged "
                     "through the host under gloo"}
    with open(j(root, "m1.json"), "w") as fh:
        json.dump(spec, fh)
    outs = spawn_ranks([[os.path.abspath(__file__), "--m1-rank",
                         j(root, "m1.json"), str(r)] for r in range(2)])
    for r, (rc, out) in enumerate(outs):
        print("".join(f"[M1 rank {r}] {line}\n"
                      for line in out.splitlines() if line.strip()), end="")
    check(all(rc == 0 for rc, _ in outs),
          f"M1 ranks exited with {[rc for rc, _ in outs]}")
    res = [json.load(open(j(root, f"m1_rank{r}.json"))) for r in range(2)]
    for r, rr in enumerate(res):
        for case in ("replicated", "zero1", "bf16_zero1"):
            check(rr[case]["ok"], f"M1 (ii) rank {r} {case}: {rr[case]}")
    print(f"[M1] (ii) two ranks on one card over gloo (collectives staged "
          f"through the host): every check passed on both ranks; (i) "
          f"{t1 - t0:.1f} s, (ii) {time.perf_counter() - t1:.1f} s with "
          f"both processes' start ({card})")


def m1_rank(spec_path, rank):
    """One rank of M1 (ii): ``spec["world"]`` ranks over ``spec["backend"]``
    on ``spec["device"]`` (``"cuda"``: card r for rank r,
    ``scripts/dp_cards.py``); writes ``m1_rank<r>.json`` into the spec's
    out directory and prints its lines."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (
        DataGroup)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed, rank_device)

    with open(spec_path) as fh:
        spec = json.load(fh)
    world = spec["world"]
    dev = rank_device(spec["device"], rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(spec["init"], world, rank,
                           backend=spec["backend"], device=dev)
    dp = DataGroup()
    cfg32 = ExperimentConfig.from_dict(spec["cfg"])
    lr = cfg32.train.lr
    weights = torch.load(spec["params"], map_location=dev, weights_only=True)
    out = {}
    ref = ref_m = ref_g = None
    if rank == 0:  # the one-process step on the whole batch, on this card
        state, ref_m, ref_g, _, _ = m_step(cfg32, weights, spec["batch"],
                                           dev)
        ref_g = [g.to(dev) for g in ref_g]
        names = ([n for n, _ in state.model.named_parameters()],
                 [n for n, p in state.model.named_parameters()
                  if p.requires_grad])
        ref = m_whole(state, dev)
        del state
        torch.cuda.empty_cache()
    n_perf = 2 * 2 * cfg32.model.num_layers
    for zero1 in (False, True):
        c = dataclasses.replace(cfg32, parallel=dataclasses.replace(
            cfg32.parallel, zero1=zero1))
        torch.cuda.reset_peak_memory_stats(dev)
        state, m, g, launches, times = m_step(c, weights, spec["batch"],
                                              dev, dp)
        peak = torch.cuda.max_memory_allocated(dev)
        g, reduce_ms = m_mean_grads(dp, g, dev)
        res = m_resident(state)
        got = m_whole(state, dev)
        del state
        held = (res["mu"] == res["nu"] <= res["shard_max"]
                and res["ema"] == res["ema_shard"] if zero1 else
                (res["mu"], res["nu"], res["ema"]) == (
                    res["trainable"], res["trainable"], res["all"]))
        counts = launches[0] == {k: n_perf for k in M_KERNELS}
        line = (f"zero1 {'on' if zero1 else 'off'}, B = {M_B // world} of "
                f"{M_B} on {dev} over {spec['backend']}, f32: loss {float(m['loss_total']):.8f}, grad_norm "
                f"{float(m['grad_norm']):.6f}; launches {launches[0]} "
                f"({n_perf} each wanted); moments + EMA resident "
                f"{res['bytes'] / 1e9:.3f} GB ({res['mu']} + {res['nu']} + "
                f"{res['ema']} elements; under zero1 at most ceil(n / W) "
                f"plus the alignment gaps, {res['shard_max']} for a moment: "
                f"{held}); max_memory_allocated in the step "
                f"{peak / 2 ** 30:.2f} GiB; {times[0]:.1f} ms a step "
                f"({spec['label']}; one all-reduce of the whole f32 "
                f"gradient alone {reduce_ms:.1f} ms)")
        ok = held and counts
        if rank == 0:
            errs = m_compare(got, ref, g, ref_g, lr, *names)
            rel = {k: abs(float(m[k]) - float(ref_m[k])) / abs(float(
                ref_m[k])) for k in ("loss_total", "grad_norm")}
            ok = (ok and m_worst(errs) <= 1
                  and max(rel.values()) <= STEP_LOSS_REL)
            line += (f"; against the one-process step: loss rel "
                     f"{rel['loss_total']:.2e}, grad_norm rel "
                     f"{rel['grad_norm']:.2e} (tol {STEP_LOSS_REL:g}), worst "
                     f"error over tolerance {errs}")
        print(f"{line} -> {'ok' if ok else 'FAIL'}", flush=True)
        out["replicated" if not zero1 else "zero1"] = {
            "ok": ok, "launches": launches[0], "ms": times[0],
            "reduce_ms": reduce_ms, "resident": res, "peak_bytes": peak}
        del got, g  # not alive in the next case's measured step
        torch.cuda.empty_cache()
    del ref, ref_g
    cbf = dataclasses.replace(m_config(cfg32, "bfloat16"),
                              parallel=dataclasses.replace(cfg32.parallel,
                                                           zero1=True))
    state, m, _, launches, times = m_step(cbf, weights, spec["batch"], dev,
                                          dp, steps=2)
    finite = all(math.isfinite(float(m[k])) for k in ("loss_total",
                                                      "grad_norm"))
    finite = finite and all(bool(torch.isfinite(p).all())
                            for p in state.model.parameters())
    counts = all(x == {k: n_perf for k in M_KERNELS} for x in launches)
    ok = finite and counts
    print(f"bf16 compute, zero1, 2 steps: loss {float(m['loss_total']):.6f}"
          f", finite {finite}; launches per step {launches}; ms "
          f"{[round(x, 1) for x in times]} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    out["bf16_zero1"] = {"ok": ok, "launches": launches, "ms": times}
    with open(os.path.join(spec["out"], f"m1_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


def spawn_ranks(argvs, timeout=300, meanwhile=None):
    """One process per argv (this interpreter, from the repo root), their
    output in files; runs ``meanwhile()`` here while they start, if given;
    waits for all, and kills every one still running ``timeout`` s after
    the start or 30 s after another failed; [(returncode, output)]."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (here, env.get("PYTHONPATH")) if x)
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in argvs]
        procs = [subprocess.Popen([sys.executable, *argv], cwd=here, env=env,
                                  stdout=log, stderr=subprocess.STDOUT,
                                  text=True)
                 for argv, log in zip(argvs, logs)]
        deadline = time.monotonic() + timeout
        killed = ""
        try:
            if meanwhile is not None:
                meanwhile()
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    deadline = min(deadline, time.monotonic() + 30)
                if time.monotonic() > deadline:
                    killed = "\n(killed: past its deadline)"
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for p, log in zip(procs, logs):
            log.seek(0)
            outs.append((p.returncode, log.read()
                         + (killed if p.returncode < 0 else "")))
    return outs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def m2_rank(argv):
    """One rank of the train CLI where the ranks share one card (N3, M2):
    join the group that tools/train.py's launch flags in ``argv`` name over
    gloo (NCCL refuses two ranks on one device), then run the CLI's main on
    ``argv``, which finds the group made."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from motiondiffusion_moe_tpu_torch.tools import train as train_cli

    args = train_cli.build_argparser().parse_args(argv)
    # the ranks share the host's cores: none oversubscribes them
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // max(1, args.num_processes)))
    initialize_distributed(args.coordinator_address, args.num_processes,
                           args.process_id, backend="gloo",
                           device=args.device)
    try:
        train_cli.main(argv)
    finally:
        torch.distributed.destroy_process_group()


def cli_ranks(root, tag, devices, layers, widths=(), parallel=None,
              address=None):
    """(base flags, one argv per rank) of tools/train.py as one process a
    device of ``devices`` with ``parallel`` (default ``--data_parallel N
    --zero1``) at ``widths`` (flags; default the flagship's), rank 0 at
    ``address`` (default a free local port): synthetic set, 32 rows, one
    epoch of one batch, so 2 optimizer steps (cond + uncond), then the
    save."""
    n = len(devices)
    parallel = parallel or ["--data_parallel", str(n), "--zero1"]
    base = ["--dataset", "synthetic", "--synthetic_size", "32",
            "--batch_size", "32", "--num_epochs", "1", "--log_every", "1",
            "--num_layers", str(layers), *widths, "--checkpoint_dir",
            os.path.join(root, tag.lower())]
    address = address or f"127.0.0.1:{free_port()}"
    return base, [[*base, "--device", d, "--num_processes", str(n),
                   "--process_id", str(r), "--coordinator_address", address,
                   *parallel] for r, d in enumerate(devices)]


def phase_m2(dev, card, root, devices=None, layers=M2_LAYERS, tag="M2",
             widths=(), parallel=None, ran=None, holders=None):
    """tools/train.py as processes on ``devices`` (:func:`cli_ranks`),
    then a one-process resume of the run dir on ``dev``. By default two
    ranks on ``dev``; ranks that share a card each start through
    :func:`m2_rank` (gloo); ``scripts/dp_cards.py`` gives one card each,
    and the CLI picks NCCL. ``ran``: (base flags, argvs, [(returncode,
    output)], seconds) of ranks that other processes already ran (phase
    N's workers run N3 after N2), only checked here. ``holders``: the
    generator states the save holds, one a row-holder (default one a
    rank)."""
    import torch
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)

    devices = devices or [str(dev)] * 2
    n = len(devices)
    shared = len(set(devices)) < n
    how = ("over gloo, each rank joined by --m2-rank" if shared
           else "over NCCL, the CLI alone")
    j = os.path.join
    if ran is None:
        base, argvs = cli_ranks(root, tag, devices, layers, widths,
                                parallel)
        entry = ([os.path.abspath(__file__), "--m2-rank"] if shared
                 else ["-m", "motiondiffusion_moe_tpu_torch.tools.train"])
        t0 = time.perf_counter()
        outs = spawn_ranks([[*entry, *a] for a in argvs], timeout=600)
        secs = time.perf_counter() - t0
        for r, (rc, out) in enumerate(outs):
            print("".join(f"[{tag} rank {r}] {line}\n"
                          for line in out.splitlines() if line.strip()),
                  end="")
    else:
        base, argvs, outs, secs = ran
    ck = base[base.index("--checkpoint_dir") + 1]
    check(all(rc == 0 for rc, _ in outs),
          f"{tag} ranks exited with {[rc for rc, _ in outs]}")
    logs0 = re.findall(r"loss_total: (\S+)", outs[0][1])
    quiet = all("loss_total" not in out and "[train]" not in out
                for _, out in outs[1:])
    run_dir = j(ck, "t2m_moe_small")
    files = sorted(os.listdir(run_dir))
    ckpt = CheckpointManager(j(run_dir, "ckpt"))
    payload = ckpt.read()
    ok = (len(logs0) == 2 and quiet
          and files == ["ckpt", "config.json", "meta"]
          and ckpt.all_steps() == [2]
          and len(payload["rng"]) == (holders or n))
    flags = argvs[0][argvs[0].index("--coordinator_address") + 2:]
    print(f"[{tag}] tools/train.py --num_processes {n} {' '.join(flags)} "
          f"{' '.join(widths)} on {devices} {how}, {layers} blocks a scale "
          f"(full width): rank 0 logged {len(logs0)} steps {logs0}, the "
          f"other ranks no log line: {quiet}; the run dir holds {files}, "
          f"checkpoint steps {ckpt.all_steps()}, {len(payload['rng'])} "
          f"generator states; {secs:.1f} s with the processes' start "
          f"({card}) -> {'ok' if ok else 'FAIL'}")
    check(ok, f"{tag} the multi-process run")
    t0 = time.perf_counter()
    state, log, _ = run_train_cli(base + ["--device", str(dev)])
    same = (state.step == 2
            and all(same_bits(v, payload["params"][k])
                    for k, v in state.model.state_dict().items())
            and all(same_bits(a, b) for k in ("mu", "nu") for a, b in zip(
                state.optimizer.state_dict()[k], payload["opt_state"][k])))
    resumed = "resumed from step 2 (epoch 1)" in log
    print(f"[{tag}] one process resumes the run dir in "
          f"{time.perf_counter() - t0:.1f} s: {log.count('resumed')} resume "
          f"line(s), step {state.step}, its parameters and moments the "
          f"gathered ones bit for bit: {same} -> "
          f"{'ok' if same and resumed else 'FAIL'}")
    check(same and resumed, f"{tag} the one-process resume")
    del state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase N: expert-parallel MoE training (parallel/mesh.py, moe_parallel.py)
# ---------------------------------------------------------------------------

N_LAYERS = 1   # moe_big's blocks a scale in N (full width)
N_W = 8        # ranks sharing the card: moe_big's 8 expert partitions
N_ROWS = 4     # rows of 196 frames a rank (N1; N2's 32 rows over 8 ranks)
N_CASES = {    # N2: name: (ep, moe_compute, zero1, reference)
    # moe_big as written: 8 expert partitions, dense_fused (-> dense)
    "ep8_dense": (8, "dense_fused", False, "dense"),
    "ep8_dispatch": (8, "dispatch", False, "chunks"),
    "ep4x2_dispatch_zero1": (4, "dispatch", True, "chunks"),
    # ZeRO-1, so that eight whole replicas' moments fit beside each other
    "ep1x8_dispatch_zero1": (1, "dispatch", True, "global")}
N_LAYER_F32_REL = 1e-5   # N1 f32: rel RMS of output and each gradient
N_LAYER_BF16_REL = 1e-2  # N1 bf16: the same, bf16 products rounded apart
N_EMA_ABS = 1e-6         # N2: EMA against 0.999 p0 + 0.001 p1
N_MU_REL = 1e-6          # N2: mu against 0.1 x the clipped gradient
N3_FLAGS = ["--latent_dim", "768", "--ff_size", "1024", "--num_heads", "8",
            "--num_experts", "16"]


def n_config(compute="dense_fused", ep=N_W, zero1=False, dtype="float32"):
    """``ExperimentConfig.moe_big()`` as written (16 experts, 8 expert
    partitions) at N_LAYERS blocks a scale, dropout 0, no stochastic
    depth, EMA 0.999, in ``dtype`` compute, with ``compute``, ``ep`` and
    ``zero1``."""
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig

    cfg = m_config(ExperimentConfig.moe_big(), dtype)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_layers=N_LAYERS,
                                       moe_compute=compute),
        parallel=dataclasses.replace(cfg.parallel, num_expert_partitions=ep,
                                     zero1=zero1))


def chunked_dispatch(n: int):
    """``capacity_dispatch_ffn`` applied to ``n`` equal row chunks of its
    tokens: the per-chunk capacity of JAX's ``ep_moe_ffn_sharded`` (chunk r
    is rank r's rows) on one process. A reference only, not a mode of the
    package."""
    import torch
    from motiondiffusion_moe_tpu_torch.models import moe as TM

    one = TM.capacity_dispatch_ffn

    def per_chunk(x, top_idx, top_vals, *w, **kw):
        m = x.shape[0] // n
        return torch.cat([one(x[i * m:(i + 1) * m],
                              top_idx[i * m:(i + 1) * m],
                              top_vals[i * m:(i + 1) * m], *w, **kw)
                          for i in range(n)])

    return per_chunk


def n_counting_drops():
    """Count the (token, choice) pairs the dispatches drop, through the
    slots of ``parallel/moe_parallel.py`` and ``models/moe.py``:
    ({"pairs", "dropped"}, restore)."""
    from motiondiffusion_moe_tpu_torch.models import moe as TM
    from motiondiffusion_moe_tpu_torch.parallel import moe_parallel as MP

    seen = {"pairs": 0, "dropped": 0}
    saved = (MP.capacity_slots, TM.capacity_slots, MP.global_keep)

    def slots(*a):
        slot, keep = saved[1](*a)
        seen["pairs"] += keep.numel()
        seen["dropped"] += int((~keep).sum())
        return slot, keep

    def keeps(*a):
        keep = saved[2](*a)
        seen["pairs"] += keep.numel()
        seen["dropped"] += int((~keep).sum())
        return keep

    MP.capacity_slots = TM.capacity_slots = slots
    MP.global_keep = keeps

    def restore():
        MP.capacity_slots, TM.capacity_slots, MP.global_keep = saved

    return seen, restore


def n_layer_inputs(W, D):
    """N1's tokens and cotangent, all ranks' in rank order (seeded)."""
    import torch

    g = torch.Generator().manual_seed(SEED + 70)
    S = W * N_ROWS * 196
    return torch.randn(S, D, generator=g), torch.randn(S, D, generator=g)


def n_moe_layer(weights, dtype, compute, dev):
    """moe_big's first MoE layer (16 experts, hidden 1024, cf 2.0) with
    the seeded weights."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

    pre = next(k for k in weights if k.endswith("_moe.w1"))[:-2]
    sd = {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}
    E, D, hid = sd["w1"].shape
    layer = SwitchMoELayer(D, hid, E, 2, getattr(torch, dtype), compute,
                           2.0)
    layer.load_state_dict(sd)
    return layer


def n1_reference(weights, dtype, compute, W, dev):
    """The one-process layer on the card, chunk by chunk (rank r's rows, so
    the capacity of JAX's chunk r and the router's shapes of the ranks):
    ``capacity_dispatch_ffn`` routed as the expert-parallel dispatch routes
    (``ep_routing``), or the layer's ``dense``; the output, the gradients
    of x, the gate and the experts of ``sum(y * cot)`` and the dropped
    pairs, on the host."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.moe import (
        capacity_dispatch_ffn)

    layer = n_moe_layer(weights, dtype, compute, dev).to(dev)
    dt = layer.dtype
    x_all, cot = (t.to(dev) for t in n_layer_inputs(W, layer.w1.shape[1]))
    x_all = x_all.to(dt).requires_grad_()
    seen, restore = n_counting_drops()
    m = x_all.shape[0] // W
    outs = []
    for r in range(W):
        x = x_all[r * m:(r + 1) * m]
        if compute == "dispatch":
            vals, idx = layer.ep_routing(x)
            w = (p.to(dt) for p in (layer.w1, layer.b1, layer.w2, layer.b2))
            outs.append(capacity_dispatch_ffn(x, idx, vals.to(dt), *w,
                                              capacity_factor=2.0))
        else:
            outs.append(layer(x))
    restore()
    y = torch.cat(outs)
    (y.float() * cot).sum().backward()
    out = {"y": y.detach().float().cpu(), "dx": x_all.grad.float().cpu(),
           "dropped": seen["dropped"]}
    for name, p in layer.named_parameters():
        out[name] = p.grad.cpu()
    del layer
    torch.cuda.empty_cache()
    return out


def n1_rank(weights, dtype, compute, mesh, dev):
    """The same layer cut over the expert group, on this rank's rows;
    gathered to every rank (y, dx) and to rank 0 (the gradients)."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        Cut, attach_mesh, shard_params)

    layer = n_moe_layer(weights, dtype, compute, dev)
    attach_mesh(layer, mesh)
    shard_params(layer)
    layer.to(dev)
    dt = layer.dtype
    x_all, cot = n_layer_inputs(mesh.world, layer.w1.shape[1])
    m = x_all.shape[0] // mesh.world
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    x = x_all[rows].to(dev).to(dt).requires_grad_()
    seen, restore = n_counting_drops()
    y = layer(x)
    restore()
    (y.float() * cot[rows].to(dev)).sum().backward()
    out = {"y": mesh.all_gather(y.detach().float()).cpu(),
           "dx": mesh.all_gather(x.grad.float()).cpu(),
           "dropped": int(mesh.total(torch.tensor(seen["dropped"])))}
    for name in ("gate.weight", "gate.bias"):
        out[name] = mesh.total(layer.get_parameter(name).grad).cpu()
    experts = mesh.gather_blocks([getattr(layer, k).grad for k in
                                  ("w1", "b1", "w2", "b2")],
                                 [Cut(expert=True)] * 4)
    if experts is not None:
        out.update(zip(("w1", "b1", "w2", "b2"), experts))
    del layer
    torch.cuda.empty_cache()
    return out


def n1_compare(got, ref, dtype) -> dict:
    tol = N_LAYER_F32_REL if dtype == "float32" else N_LAYER_BF16_REL
    rel = {k: round(rel_rms(got[k].float(), ref[k].float()), 8)
           for k in ref if k != "dropped"}
    return {"rel_rms": rel, "tol": tol,
            "dropped": (got["dropped"], ref["dropped"]),
            "ok": max(rel.values()) <= tol
            and got["dropped"] == ref["dropped"]}


def n2_reference(kind, weights, batch_path, dev, W, config=None):
    """The one-process step of the global batch on the card: ``dense``,
    ``dispatch`` chunk by chunk (``chunks``, W chunks) or over the global
    batch (``global``), of ``config(compute, ep=1)`` (default
    :func:`n_config`); the loss, grad_norm, the gradients (trainable
    order) and the parameters after the update, on the host."""
    import torch
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule)
    from motiondiffusion_moe_tpu_torch.models import moe as TM
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state)

    cfg = (config or n_config)("dense" if kind == "dense" else "dispatch",
                               ep=1)
    with torch.device(dev):
        model = MotionTransformer(cfg.model)
    model.load_state_dict(weights)
    state = create_train_state(model, cfg)
    step = TrainStep(make_schedule(
        schedule_name=cfg.diffusion.beta_schedule,
        num_timesteps=cfg.diffusion.num_timesteps, device=dev), cfg)
    batch, noise = m_rows(batch_path, dev)
    one = TM.capacity_dispatch_ffn
    if kind == "chunks":
        TM.capacity_dispatch_ffn = chunked_dispatch(W)
    try:
        metrics = step.backward(state, batch, None, noise=noise)
    finally:
        TM.capacity_dispatch_ffn = one
    grads = [p.grad.cpu() for p in state.optimizer.params]
    metrics = step.apply_update(state, metrics)
    out = {"loss": float(metrics["loss_total"]),
           "grad_norm": float(metrics["grad_norm"]), "grads": grads,
           "params": {k: v.cpu() for k, v in model.state_dict().items()}}
    del model, state
    torch.cuda.empty_cache()
    return out


def n2_step(name, weights, batch_path, mesh, dev):
    """One N2 case on this rank through the Trainer (its mesh, its
    dense_fused -> dense, its TrainStep): the launches, ms, peak memory and
    resident expert elements of the step, and on rank 0 the global
    gradients (caught where the optimizer clips them), the parameters,
    mu and the EMA after the update, gathered to its host."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.distributed import barrier
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        gather_whole, is_expert_param, shard_params, whole_state_dict)
    from motiondiffusion_moe_tpu_torch.training import train_state as TS
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    ep, compute, zero1, _ = N_CASES[name]
    trainer = Trainer(n_config(compute, ep, zero1), device=dev)
    model = trainer.model
    model.load_state_dict(weights)
    shard_params(model)
    model.to(dev)
    state = TS.create_train_state(model, trainer.cfg, dp=trainer.dp)
    opt = state.optimizer
    W = mesh.world
    h = M_B // W
    batch, noise = m_rows(batch_path, dev, slice(mesh.rank * h,
                                                 (mesh.rank + 1) * h))
    counted = [getattr(P, k) for k in M_KERNELS]
    for c in counted:
        c.launches = 0
    caught = {}
    clip = TS.clip_by_norm_

    def catch(grads, norm, max_norm):  # the reduced gradient, pre-clip
        t0 = time.perf_counter()
        whole = (opt.layout.gather(grads) if opt.zero1
                 else gather_whole(grads, opt.cuts, opt.mesh))
        if mesh.rank == 0:
            caught["grads"] = [g.detach().cpu().clone() for g in whole]
        caught["s"] = time.perf_counter() - t0
        return clip(grads, norm, max_norm)

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    barrier()
    t0 = time.perf_counter()
    metrics = trainer.train_step.backward(state, batch, None, noise=noise)
    torch.cuda.synchronize()
    TS.clip_by_norm_ = catch
    try:
        metrics = trainer.train_step.apply_update(state, metrics)
    finally:
        TS.clip_by_norm_ = clip
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0 - caught["s"]) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {c.__name__: c.launches for c in counted}
    held = sum(p.numel() for n, p in model.named_parameters()
               if is_expert_param(n))
    out = {"ms": ms, "peak_bytes": peak, "launches": launches,
           "expert_elements": held,
           "computes": sorted({m.compute for m in model.modules()
                               if hasattr(m, "capacity_factor")}),
           "loss": float(metrics["loss_total"]),
           "grad_norm": float(metrics["grad_norm"])}
    whole = whole_state_dict(model)
    # the ZeRO-1 layouts' own gathers; without ZeRO-1 the moments and the
    # EMA take the parameters' path
    mu = opt.state_dict()["mu"] if zero1 else None
    ema = state.ema.state_dict()["params"] if zero1 else None
    if mesh.rank == 0:
        names = [n for n, _ in model.named_parameters()]
        out.update(grads=caught["grads"], names=names,
                   tnames=[n for n, p in model.named_parameters()
                           if p.requires_grad],
                   params={k: v.cpu() for k, v in whole.items()})
        if zero1:
            out.update(mu=[m.cpu() for m in mu], ema=[e.cpu() for e in ema])
    del trainer, model, state, opt, batch, noise
    torch.cuda.empty_cache()
    return out


def n2_compare(got, ref, weights, lr, dev) -> dict:
    """Rank 0's checks of one N2 case, on ``dev``: the loss and grad_norm
    (rtol STEP_LOSS_REL), the gradients (:func:`rel_rms_rule`) and the
    parameters (:func:`step_rule`) as M1 holds them, and under ZeRO-1 the
    gathered layout: the EMA within N_EMA_ABS of 0.999 p0 + 0.001 p1, mu
    within N_MU_REL (rel RMS) of 0.1 x the gradient clipped at
    grad_norm."""
    names, tnames = got["names"], got["tnames"]
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ("loss",
                                                             "grad_norm")}
    on = lambda ts: [t.to(dev) for t in ts]  # noqa: E731
    g_got, g_ref = on(got["grads"]), on(ref["grads"])
    grads = rel_rms_rule(zip(g_got, g_ref))
    steps = step_rule(zip(on(got["params"][n] for n in tnames),
                          on(ref["params"][n] for n in tnames)), g_ref, lr)
    ema = mu = 0.0
    if "mu" in got:  # the ZeRO-1 layouts
        ema = max(float((e.to(dev) - (0.999 * weights[n].to(dev) + 0.001
                                      * got["params"][n].to(dev)))
                        .abs().max())
                  for n, e in zip(names, got["ema"]))
        scale = min(1.0, 1.0 / got["grad_norm"])
        mu = max(rel_rms(m.to(dev), 0.1 * g * scale)
                 for m, g in zip(got["mu"], g_got) if g.abs().max() > 0)
    ok = (max(rel.values()) <= STEP_LOSS_REL and grads[0] <= 1
          and steps[0] <= 1 and ema <= N_EMA_ABS and mu <= N_MU_REL)
    return {"rel": {k: f"{v:.2e}" for k, v in rel.items()},
            "grads": (round(grads[0], 4), tnames[grads[1]]),
            "params": (round(steps[0], 4), tnames[steps[1]]),
            "ema_abs": f"{ema:.2e}", "mu_rel_rms": f"{mu:.2e}", "ok": ok}


def n_rank(spec_path, rank):
    """One of phase N's ranks, over gloo on the one card: N1 and N2, then,
    in a process group of its own, N3's rank of the train CLI
    (:func:`m2_rank`); writes ``n_rank<r>.json`` into the spec's out
    directory and prints its lines."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        barrier, initialize_distributed)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import ExpertMesh

    with open(spec_path) as fh:
        spec = json.load(fh)
    W, dev = spec["world"], torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(spec["init"], W, rank, backend="gloo",
                           device=dev)
    mesh = ExpertMesh(W)
    weights = torch.load(spec["params"], mmap=True, weights_only=True)
    res = {"n1": {}, "n2": {}}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        for compute in ("dispatch", "dense"):
            ref = (n1_reference(weights, dtype, compute, W, dev)
                   if rank == 0 else None)
            got = n1_rank(weights, dtype, compute, mesh, dev)
            if rank == 0:
                cmp = n1_compare(got, ref, dtype)
                res["n1"][f"{compute} {dtype}"] = cmp
                print(f"N1 {compute} {dtype}, E = 16 over ep = {W}, "
                      f"{N_ROWS} x 196 tokens a rank: {cmp} -> "
                      f"{'ok' if cmp['ok'] else 'FAIL'}", flush=True)
    barrier()
    res["n1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = {}
    if rank == 0:  # before the ranks' states take the card
        for kind in ("dense", "chunks", "global"):
            refs[kind] = n2_reference(kind, weights, spec["batch"], dev, W)
        res["refs_s"] = time.perf_counter() - t0
    barrier()
    for name, (ep, compute, _, kind) in N_CASES.items():
        out = n2_step(name, weights, spec["batch"], mesh, dev)
        whole_experts = sum(v.numel() for k, v in weights.items()
                            if k.endswith(("_moe.w1", "_moe.b1", "_moe.w2",
                                           "_moe.b2")))
        line = {"ms": round(out["ms"], 1),
                "peak_GiB": round(out["peak_bytes"] / 2 ** 30, 2),
                "launches": out["launches"],
                "expert_elements": out["expert_elements"],
                "one_ep_th": out["expert_elements"] * ep == whole_experts,
                "computes": out["computes"], "loss": out["loss"]}
        n_perf = 2 * 2 * N_LAYERS
        ok = (line["one_ep_th"]
              and out["launches"] == {k: n_perf for k in M_KERNELS}
              and out["computes"] == ["dense" if compute == "dense_fused"
                                      and ep > 1 else compute])
        if rank == 0:
            cmp = n2_compare(out, refs[kind], weights, spec["lr"], dev)
            line["against_reference"] = cmp
            ok = ok and cmp["ok"]
        line["ok"] = ok
        res["n2"][name] = line
        print(f"N2 {name} (rank {rank}): {line} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del out
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m2_rank(spec["cli"][rank])  # N3: the train CLI, its own group
    res["n3_s"] = time.perf_counter() - t0
    with open(os.path.join(spec["out"], f"n_rank{rank}.json"), "w") as fh:
        json.dump(res, fh, default=str)


def phase_n(dev, card):
    """Expert-parallel MoE training (see the module doc): N1 and N2 on
    N_W ranks sharing this card over gloo, each an ``--n-rank`` worker;
    N3 tools/train.py as N_W processes, then a one-process resume."""
    import torch

    t0 = time.perf_counter()
    j = os.path.join
    with tempfile.TemporaryDirectory() as root:
        cfg = n_config()
        weights = build_flagship(cfg).state_dict()
        n_params = sum(v.numel() for v in weights.values())
        torch.save(weights, j(root, "n_params.pt"))
        del weights
        m_batch(cfg, j(root, "n_batch.npz"))
        t_write = time.perf_counter() - t0
        n3 = cli_ranks(root, "N3", [str(dev)] * N_W, N_LAYERS, N3_FLAGS,
                       ["--expert_parallel", str(N_W), "--data_parallel",
                        "1", "--zero1"], f"file://{j(root, 'rdv_n3')}")
        spec = {"init": f"file://{j(root, 'rdv_n')}", "world": N_W,
                "device": str(dev), "params": j(root, "n_params.pt"),
                "batch": j(root, "n_batch.npz"), "out": root,
                "lr": cfg.train.lr, "cli": n3[1]}
        with open(j(root, "n.json"), "w") as fh:
            json.dump(spec, fh)
        print(f"[N] moe_big at {N_LAYERS} blocks a scale (full width, 16 "
              f"experts): {n_params} parameters seeded and written for the "
              f"ranks in {t_write:.1f} s")
        outs = spawn_ranks([[os.path.abspath(__file__), "--n-rank",
                             j(root, "n.json"), str(r)]
                            for r in range(N_W)], timeout=1000)
        for r, (rc, out) in enumerate(outs):
            print("".join(f"[N rank {r}] {line}\n"
                          for line in out.splitlines() if line.strip()),
                  end="")
        check(all(rc == 0 for rc, _ in outs),
              f"N ranks exited with {[rc for rc, _ in outs]}")
        res = [json.load(open(j(root, f"n_rank{r}.json")))
               for r in range(N_W)]
        for k, v in res[0]["n1"].items():
            check(v["ok"], f"N1 {k}: {v}")
        launches = {}
        for name in N_CASES:
            for r, rr in enumerate(res):
                check(rr["n2"][name]["ok"], f"N2 {name} rank {r}: "
                                            f"{rr['n2'][name]}")
            launches[name] = res[0]["n2"][name]["launches"]
            ms = [rr["n2"][name]["ms"] for rr in res]
            peak = [rr["n2"][name]["peak_GiB"] for rr in res]
            print(f"[N2] {name}: every rank ok; ms a step {min(ms)}-"
                  f"{max(ms)} (eight ranks sharing one card, collectives "
                  f"staged through the host under gloo: not a speed); "
                  f"max_memory_allocated {min(peak)}-{max(peak)} GiB a "
                  f"rank; expert elements a rank "
                  f"{res[0]['n2'][name]['expert_elements']} ({card})")
        t1 = time.perf_counter()
        n3_s = res[0]["n3_s"]
        print(f"[N] N1 {res[0]['n1_s']:.1f} s, the references "
              f"{res[0]['refs_s']:.1f} s, N1 + N2 + N3's ranks "
              f"{t1 - t0 - t_write:.1f} s with the ranks' start, N3's ranks "
              f"{n3_s:.1f} s of it")
        phase_m2(dev, card, root, devices=[str(dev)] * N_W,
                 layers=N_LAYERS, tag="N3", widths=N3_FLAGS,
                 ran=(*n3, outs, n3_s))
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"[N] phase N in {now - t0:.1f} s (the resume {now - t1:.1f} s) "
          f"({card})")
    return launches


# ---------------------------------------------------------------------------
# phase P: tensor-parallel training (the model axis's Megatron split)
# ---------------------------------------------------------------------------

P_LAYERS = 1   # the flagship's blocks a scale in P (full width)
P_W = 4        # ranks sharing the card: two model groups of two
P_CASES = {    # name: (ep, tp, sp, moe_compute, zero1, reference, pp)
    "sp2tp2_dense": (1, 2, 2, "dense", False, "dense", 1),
    "sp4_dense": (1, 1, 4, "dense", False, "dense", 1),
    "ep2tp2_dispatch_zero1": (2, 2, 1, "dispatch", True, "chunks", 1),
    # data 2 x pipe 2: its own model, P3_LAYERS blocks a scale
    "dp2pp2_dense_fused": (1, 1, 1, "dense_fused", False, "pipe", 2)}
P3_LAYERS = 2  # the pipe case's blocks a scale (one a stage)
P3_M = 4       # its microbatches: 16 rows a data rank, 4 a microbatch
P3_LOSS_REL = 1e-6  # its loss against the one process's
# kernels 1 and 3 on a seq rank: the split's launches
SPLIT_KERNELS = ("favor_qkv_moments", "favor_qkv_apply", "favor_qkv_bwd_kv",
                 "favor_qkv_bwd_q", "favor_qkv_bwd_k")
P_KERNELS = M_KERNELS + SPLIT_KERNELS
P_STEP_ABS = 2e-6   # the update of the gathered gradient, and the EMA
P_MU_REL = 1e-5     # mu against the one-process Adam's, of its largest


def p_config(compute="dense_fused", ep=1, zero1=False, tp=2, sp=1, pp=1):
    """The flagship at P_LAYERS blocks a scale (M1's config: dropout 0, no
    stochastic depth, EMA 0.999, f32 compute) with ``compute`` over ``sp``
    seq x ``ep`` expert x ``tp`` model partitions; with ``pp`` (the pipe
    case, one process at pp 1 below it) at P3_LAYERS blocks a scale and
    P3_M microbatches over ``pp`` stages."""
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig

    cfg = m_config(ExperimentConfig.moe_small())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, num_layers=P_LAYERS if pp == 1 else P3_LAYERS,
            moe_compute=compute, pipeline_microbatches=P3_M),
        parallel=dataclasses.replace(cfg.parallel, num_expert_partitions=ep,
                                     num_model_partitions=tp,
                                     num_seq_partitions=sp,
                                     num_pipeline_stages=pp, zero1=zero1))


def p3_reference(weights, batch_path, dev):
    """The pipe case's one-process step on the card (P3_LAYERS blocks a
    scale): the losses of the whole batch plus the MoE balance term as the
    ring counts it (JAX's PP estimate: each layer's Switch aux on each of
    the ring's 2 x P3_M chunks of M_B / (2 P3_M) rows, averaged over them,
    each chunk one more forward here); the loss, grad_norm and the
    gradients (trainable order), on the host."""
    import torch
    from motiondiffusion_moe_tpu_torch.diffusion.gaussian import (
        make_schedule, q_sample)
    from motiondiffusion_moe_tpu_torch.models.layers import TrainContext
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        TrainStep, create_train_state, grouped_global_norm)

    cfg = p_config(tp=1, pp=2)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, num_pipeline_stages=1))
    w = cfg.model.moe_aux_loss_weight
    with torch.device(dev):
        model = MotionTransformer(cfg.model)
    model.load_state_dict(weights)
    state = create_train_state(model, cfg)
    rec = TrainStep(make_schedule(
        schedule_name=cfg.diffusion.beta_schedule,
        num_timesteps=cfg.diffusion.num_timesteps, device=dev),
        dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, moe_aux_loss_weight=0.0)))
    batch, noise = m_rows(batch_path, dev)
    model.train()
    state.optimizer.zero_grad()
    total, _ = rec.loss(model, batch, noise)
    x_t = q_sample(rec.sched, batch["motion"], batch["t"], noise)
    chunks = 2 * P3_M
    c = M_B // chunks
    aux = torch.zeros((), device=dev)
    for k in range(chunks):
        rows = slice(k * c, (k + 1) * c)
        ctx = TrainContext()
        model(x_t[rows], batch["t"][rows], batch["length"][rows],
              text_ids=batch["text_ids"][rows], ctx=ctx)
        aux = aux + torch.stack(ctx.aux_losses).sum()
    loss = total + w * aux / chunks
    loss.backward()
    grads = [p.grad.detach().cpu() for p in state.optimizer.params]
    out = {"loss": float(loss), "grads": grads,
           "grad_norm": float(grouped_global_norm(grads))}
    del model, state
    torch.cuda.empty_cache()
    return out


def p_step(name, weights, batch_path, dev):
    """One P1 case on this rank through the Trainer (its (data, expert,
    model) mesh, its TrainStep): on every rank the launches, ms, peak
    memory and the elements it holds of each leaf that JAX's rule cuts;
    on rank 0 the global gradient (caught where the optimizer clips it),
    the parameters, mu and the EMA after the update."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.distributed import barrier
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        gather_whole, is_expert_param, leaf_cuts, model_dim, shard_params,
        whole_model, whole_state_dict)
    from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
        format_pp_memory_report, pp_stage_memory_report)
    from motiondiffusion_moe_tpu_torch.training import train_state as TS
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    ep, tp, sp, compute, zero1, _, pp = P_CASES[name]
    trainer = Trainer(p_config(compute, ep, zero1, tp, sp, pp), device=dev)
    mesh, model = trainer.dp, trainer.model
    model.load_state_dict(weights)
    shard_params(model)
    model.to(dev)
    state = TS.create_train_state(model, trainer.cfg, dp=mesh)
    opt = state.optimizer
    # the model and seq ranks of a row-holder share rows (a seq rank's step
    # takes its frames)
    h = M_B // mesh.holders
    batch, noise = m_rows(batch_path, dev, slice(mesh.q * h,
                                                 (mesh.q + 1) * h))
    counted = [getattr(P, k) for k in P_KERNELS]
    for c in counted:
        c.launches = 0
    caught = {}
    clip = TS.clip_by_norm_

    def catch(grads, norm, max_norm):  # the reduced gradient, pre-clip
        t0 = time.perf_counter()
        whole = (opt.layout.gather(grads) if opt.zero1
                 else gather_whole(grads, opt.cuts, opt.mesh))
        if mesh.rank == 0:
            caught["grads"] = [g.detach().cpu().clone() for g in whole]
        caught["s"] = time.perf_counter() - t0
        return clip(grads, norm, max_norm)

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    barrier()
    t0 = time.perf_counter()
    metrics = trainer.train_step.backward(state, batch, None, noise=noise)
    torch.cuda.synchronize()
    TS.clip_by_norm_ = catch
    try:
        metrics = trainer.train_step.apply_update(state, metrics)
    finally:
        TS.clip_by_norm_ = clip
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0 - caught["s"]) * 1e3
    shares = {}  # each cut leaf: the global elements over the rank's
    for n, p in model.named_parameters():
        div = ep if ep > 1 and is_expert_param(n) else 1
        if model_dim(n, weights[n].shape, mesh.tp) is not None:
            div *= mesh.tp
        if div > 1:
            shares[n] = (weights[n].numel() / p.numel(), div)
    out = {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": {c.__name__: c.launches for c in counted},
           "shares_ok": all(a == b for a, b in shares.values()),
           "cut_leaves": len(shares),
           "computes": sorted({m.compute for m in model.modules()
                               if hasattr(m, "capacity_factor")}),
           "row_holder": (mesh.q, mesh.holders),
           "loss": float(metrics["loss_total"]),
           "grad_norm": float(metrics["grad_norm"])}
    if pp > 1:  # the stage's blocks held, the stage report, the copies
        cuts = leaf_cuts(model)
        held = {n: p for n, p in model.named_parameters()}
        report = pp_stage_memory_report(
            list(whole_model(model).named_parameters()), pp, ema=True,
            batch=M_B // mesh.dp, num_microbatches=P3_M,
            max_frames=trainer.cfg.model.max_frames,
            latent_dim=trainer.cfg.model.latent_dim)
        digest = hashlib.sha256()
        for n, p in held.items():
            if not cuts[n].stage:
                digest.update(p.detach().cpu().numpy().tobytes())
        out.update(
            stage=mesh.p, block_bytes=sum(
                p.numel() * p.element_size() for n, p in held.items()
                if cuts[n].stage),
            blocks_held=sorted({".".join(n.split(".")[:2]) for n in held
                                if cuts[n].stage}),
            report_stage_bytes=report["stage_state_bytes"],
            report_block_bytes=report["param_bytes_blocks"],
            report=format_pp_memory_report(report),
            replicated_sha256=digest.hexdigest())
    whole = whole_state_dict(model)
    mu = opt.state_dict()["mu"]
    ema = state.ema.state_dict()["params"]
    if mesh.rank == 0:
        named = list(whole_model(model).named_parameters())
        out.update(grads=caught["grads"],
                   tnames=[n for n, p in named if p.requires_grad],
                   names=[n for n, _ in named],
                   params={k: v.cpu() for k, v in whole.items()},
                   mu=[m.cpu() for m in mu], ema=[e.cpu() for e in ema])
    del trainer, model, state, opt, batch, noise
    torch.cuda.empty_cache()
    return out


def p_compare(got, ref, weights, dev, cfg=None) -> dict:
    """Rank 0's checks of one P1 case, on ``dev``: the loss and grad_norm
    against the one-process step's (rtol STEP_LOSS_REL), the gradients by
    :func:`rel_rms_rule` (N2's rule) and by the tests' rule (each within
    1e-4 of its leaf's largest entry plus 1e-7), and, as
    tests/test_torch_moe_parallel holds the update, the one-process
    optimizer applied to the gathered gradient: the parameters and the EMA
    within P_STEP_ABS, mu within P_MU_REL of its largest entry."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.training.train_state import (
        create_train_state)

    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ("loss",
                                                             "grad_norm")}
    on = lambda ts: [t.to(dev) for t in ts]  # noqa: E731
    grads = rel_rms_rule(zip(on(got["grads"]), on(ref["grads"])))
    tests_rule = max(float((a.to(dev) - b).abs().max()
                           / (1e-4 * b.abs().max() + 1e-7))
                     for a, b in zip(got["grads"], on(ref["grads"])))
    cfg = cfg or p_config(tp=1)
    with torch.device(dev):
        model = MotionTransformer(cfg.model)
    model.load_state_dict(weights)
    state = create_train_state(model, cfg)
    for p, g in zip(state.optimizer.params, got["grads"]):
        p.grad = g.to(dev)
    state.optimizer.step()
    state.ema.update(model)
    want = model.state_dict()
    params = max(float((got["params"][n].to(dev) - want[n]).abs().max())
                 for n in got["tnames"])
    ema = max(float((e.to(dev) - w).abs().max())
              for e, w in zip(got["ema"], state.ema.params))
    mu = max(float((m.to(dev) - w).abs().max())
             / max(float(w.abs().max()), 1e-30)
             for m, w in zip(got["mu"], state.optimizer.mu))
    ok = (max(rel.values()) <= STEP_LOSS_REL and grads[0] <= 1
          and tests_rule <= 1
          and params <= P_STEP_ABS and ema <= P_STEP_ABS and mu <= P_MU_REL)
    del model, state
    torch.cuda.empty_cache()
    return {"rel": {k: f"{v:.2e}" for k, v in rel.items()},
            "grads": (round(grads[0], 4), got["tnames"][grads[1]]),
            "grads, tests' rule": f"{tests_rule:.2e}",
            "params_abs": f"{params:.2e}", "ema_abs": f"{ema:.2e}",
            "mu_rel": f"{mu:.2e}", "ok": ok}


def p_rank(spec_path, rank):
    """One of phase P's ranks, over gloo on the one card: P1, then, in a
    process group of its own, P2's rank of the train CLI
    (:func:`m2_rank`); writes ``p_rank<r>.json`` into the spec's out
    directory and prints its lines."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        barrier, initialize_distributed)

    with open(spec_path) as fh:
        spec = json.load(fh)
    W, dev = spec["world"], torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // W))
    initialize_distributed(spec["init"], W, rank, backend="gloo",
                           device=dev)
    weights = torch.load(spec["params"], mmap=True, weights_only=True)
    weights3 = torch.load(spec["params3"], mmap=True, weights_only=True)
    res = {"p1": {}}
    t0 = time.perf_counter()
    refs = {}
    if rank == 0:  # before the ranks' states take the card
        for kind in ("dense", "chunks"):
            refs[kind] = n2_reference(kind, weights, spec["batch"], dev, 2,
                                      config=p_config)
        refs["pipe"] = p3_reference(weights3, spec["batch"], dev)
        res["refs_s"] = time.perf_counter() - t0
    barrier()
    for name, (ep, tp, sp, compute, _, kind, pp) in P_CASES.items():
        out = p_step(name, weights3 if pp > 1 else weights, spec["batch"],
                     dev)
        # a seq rank launches kernels 1 and 3 split, never whole
        split = set(SPLIT_KERNELS) if sp > 1 else {"favor_qkv",
                                                    "favor_qkv_bwd"}
        runs = (set(P_KERNELS) - {"favor_qkv", "favor_qkv_bwd"}
                - set(SPLIT_KERNELS)) | split
        # 2 Performers a block, 2 scales; a stage its own blocks alone,
        # once a microbatch
        n_perf = (2 * 2 * P_LAYERS if pp == 1
                  else 2 * 2 * (P3_LAYERS // pp) * P3_M)
        d, e = rank // (tp * ep * sp * pp), rank // tp % ep
        holders = W // (sp * ep * tp * pp) * ep
        line = {"ms": round(out["ms"], 1),
                "peak_GiB": round(out["peak_bytes"] / 2 ** 30, 2),
                "launches": out["launches"], "shares_ok": out["shares_ok"],
                "cut_leaves": out["cut_leaves"],
                "row_holder": out["row_holder"],
                "computes": out["computes"], "loss": out["loss"]}
        ok = (out["shares_ok"] and (out["cut_leaves"] > 0) == (tp > 1)
              and out["launches"] == {k: n_perf if k in runs else 0
                                      for k in P_KERNELS}
              and out["computes"] == [compute]
              and out["row_holder"] == (d * ep + e, holders))
        if pp > 1:
            k = P3_LAYERS // pp
            line.update({x: out[x] for x in (
                "stage", "blocks_held", "block_bytes", "report_stage_bytes",
                "replicated_sha256")})
            print(f"P1 {name} rank {rank}: {out['report']}", flush=True)
            ok = (ok and out["block_bytes"] * pp == out["report_block_bytes"]
                  and out["blocks_held"] == sorted(
                      f"{s}.{i}" for s in ("blocks_low", "blocks_high")
                      for i in range(out["stage"] * k,
                                     (out["stage"] + 1) * k)))
        if rank == 0:
            cmp = p_compare(out, refs[kind], weights3 if pp > 1 else weights,
                            dev, p_config(tp=1, pp=2) if pp > 1 else None)
            if pp > 1:  # the loss to 1e-6 against the one process's
                loss_rel = abs(out["loss"] - refs[kind]["loss"]) / abs(
                    refs[kind]["loss"])
                cmp["loss_rel"] = f"{loss_rel:.2e}"
                cmp["ok"] = cmp["ok"] and loss_rel <= P3_LOSS_REL
            line["against_reference"] = cmp
            ok = ok and cmp["ok"]
        line["ok"] = ok
        res["p1"][name] = line
        print(f"P1 {name} (rank {rank}): {line} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del out
    res["p1_s"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m2_rank(spec["cli"][rank])  # P2: the train CLI, its own group
    res["p2_s"] = time.perf_counter() - t0
    with open(os.path.join(spec["out"], f"p_rank{rank}.json"), "w") as fh:
        json.dump(res, fh, default=str)


def phase_p(dev, card):
    """Tensor-parallel training (see the module doc): P1 on P_W ranks
    sharing this card over gloo, each a ``--p-rank`` worker; P2
    tools/train.py --tensor_parallel 2 as P_W processes, then a
    one-process resume. Returns the launches of kernels 1-4 a rank a
    step in each layout."""
    import torch

    t0 = time.perf_counter()
    j = os.path.join
    with tempfile.TemporaryDirectory() as root:
        cfg = p_config()
        weights = build_flagship(cfg).state_dict()
        n_params = sum(v.numel() for v in weights.values())
        torch.save(weights, j(root, "p_params.pt"))
        del weights
        torch.save(build_flagship(p_config(tp=1, pp=2)).state_dict(),
                   j(root, "p3_params.pt"))
        m_batch(cfg, j(root, "p_batch.npz"))
        t_write = time.perf_counter() - t0
        p2 = cli_ranks(root, "P2", [str(dev)] * P_W, P_LAYERS, (),
                       ["--tensor_parallel", "2", "--zero1"],
                       f"file://{j(root, 'rdv_p2')}")
        spec = {"init": f"file://{j(root, 'rdv_p')}", "world": P_W,
                "device": str(dev), "params": j(root, "p_params.pt"),
                "params3": j(root, "p3_params.pt"),
                "batch": j(root, "p_batch.npz"), "out": root,
                "cli": p2[1]}
        with open(j(root, "p.json"), "w") as fh:
            json.dump(spec, fh)
        print(f"[P] the flagship at {P_LAYERS} block a scale (full width): "
              f"{n_params} parameters seeded and written for the ranks in "
              f"{t_write:.1f} s")
        outs = spawn_ranks([[os.path.abspath(__file__), "--p-rank",
                             j(root, "p.json"), str(r)]
                            for r in range(P_W)], timeout=600)
        for r, (rc, out) in enumerate(outs):
            print("".join(f"[P rank {r}] {line}\n"
                          for line in out.splitlines() if line.strip()),
                  end="")
        check(all(rc == 0 for rc, _ in outs),
              f"P ranks exited with {[rc for rc, _ in outs]}")
        res = [json.load(open(j(root, f"p_rank{r}.json")))
               for r in range(P_W)]
        launches = {}
        for name in P_CASES:
            for r, rr in enumerate(res):
                check(rr["p1"][name]["ok"], f"P1 {name} rank {r}: "
                                            f"{rr['p1'][name]}")
            launches[name] = res[0]["p1"][name]["launches"]
            if P_CASES[name][6] > 1:  # the replicated leaves, every rank
                shas = {rr["p1"][name]["replicated_sha256"] for rr in res}
                check(len(shas) == 1, f"P1 {name}: the ranks' replicated "
                                      f"leaves differ after the step")
                print(f"[P1] {name}: the replicated leaves bit for bit the "
                      "same on the four ranks; blocks a rank "
                      f"{[rr['p1'][name]['blocks_held'] for rr in res]}, "
                      f"block bytes a rank "
                      f"{[rr['p1'][name]['block_bytes'] for rr in res]}; "
                      f"pp_stage_memory_report's train state a stage "
                      f"{res[0]['p1'][name]['report_stage_bytes'] / 2**30:.3f}"
                      f" GiB beside max_memory_allocated "
                      f"{[rr['p1'][name]['peak_GiB'] for rr in res]} GiB a "
                      f"rank (the step's activations included) ({card})")
            ms = [rr["p1"][name]["ms"] for rr in res]
            peak = [rr["p1"][name]["peak_GiB"] for rr in res]
            print(f"[P1] {name}: every rank ok; kernels 1-4 a rank "
                  f"{launches[name]}; ms a step {min(ms)}-{max(ms)} (four "
                  f"ranks sharing one card, collectives staged through the "
                  f"host under gloo: not a speed); max_memory_allocated "
                  f"{min(peak)}-{max(peak)} GiB a rank ({card})")
        t1 = time.perf_counter()
        print(f"[P] the references {res[0]['refs_s']:.1f} s, P1 "
              f"{res[0]['p1_s']:.1f} s, P2's ranks {res[0]['p2_s']:.1f} s, "
              f"all with the ranks' start {t1 - t0 - t_write:.1f} s")
        phase_m2(dev, card, root, devices=[str(dev)] * P_W,
                 layers=P_LAYERS, tag="P2", ran=(*p2, outs, res[0]["p2_s"]),
                 holders=P_W // 2)
    torch.cuda.empty_cache()
    now = time.perf_counter()
    print(f"[P] phase P in {now - t0:.1f} s (the resume {now - t1:.1f} s) "
          f"({card})")
    return launches


# ---------------------------------------------------------------------------
# phase O: sampling, serving and evaluation over ranks
# ---------------------------------------------------------------------------

O_W = 4             # O1 and O2: ranks sharing the card
O_MB = 16           # the micro-batch (16 prompts, one micro-batch in O1)
O1_STEPS = 2        # O1's DPM-Solver++ steps (the budget's cut: 20 asked)
# (data 2 x expert 2 in dense gave way to sp2_ep2, the dense expert split,
# and dispatch_dp2_ep2, the data x expert rows; dispatch at seq 2 x expert
# 2, 25 s of host-staged gathers a run, to the CPU tests)
# (sp2_ep2 gave way to dp2_pp2: its seq cut stays in dp2_sp2 and sp4, its
# dense expert split in ep2_tp2)
O1_LAYOUTS = {      # name: ((dp, ep, tp, sp, pp), moe_compute, capacity
    "dp2_sp2": ((2, 1, 1, 2, 1), "dense_fused", 2.0),    # factor)
    "ep2_tp2": ((1, 2, 2, 1, 1), "dense_fused", 2.0),
    "dispatch_dp2_ep2": ((2, 2, 1, 1, 1), "dispatch", 4.0),
    "sp4": ((1, 1, 1, 4, 1), "dense_fused", 2.0),        # 50/50/48/48 frames
    "dp2_pp2": ((2, 1, 1, 1, 2), "dense_fused", 2.0)}    # 4 blocks a stage
O1_REL = 1e-3       # O1, f32 compute: rel RMS of the motions
O2_REL = 1e-1       # O2, bf16 compute (routing flips): rel RMS per request
O2_MB = 4           # O2's serving micro-batch
O2_STEPS = 2        # O2's DPM-Solver++ steps (the budget's cut)
O2_REQUESTS = [(1, 196, 11), (3, 150, 12), (6, 196, 13)]  # n, frames, seed
O3_W = 8            # moe_big's expert partitions, one rank each
O3_STEPS = 3        # O3's DPM-Solver++ steps (the budget's cut)
O3_LAYERS = 1       # O3's blocks a scale (moe_big has 12; full width)
# O3, f32 compute: rel RMS of the motions within O3_REL plus O3_FLOOR x the
# one process's own dense against dense_fused (the same function summed in
# another order: what the sampler makes of f32 reordering in this model;
# the 4 was set after a run that failed at 1e-3 alone, so this trajectory
# check is a loose one)
O3_REL, O3_FLOOR = 1e-3, 4.0
# O3's strict check: one denoiser forward (no sampler) of the ranks against
# the one process's dense, f32 compute: phase K1's f32 tolerance for the
# same kind of difference (expert sums in another order)
O3_FWD_REL = 1e-4
O3_FWD_T = 500      # the timestep of that forward
O4_REL = 1e-2       # O4: each metric of the one replication, relative


def o_prompts(n, frames):
    return ([f"a person walks in a circle and waves {i}" for i in range(n)],
            [frames - (i % 3) * 7 for i in range(n)])


def o_generate(pipe, prompts, lengths, seed, dev):
    """``pipe.generate`` with kernels 1 (whole, and its two seq launches)
    and 2 counted from just before it to just after it; (motions, {seconds,
    launches, peak GiB})."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counted = (P.favor_qkv, P.favor_qkv_moments, P.favor_qkv_apply,
               P.performer_epilogue)
    for c in counted:
        c.launches = 0
    t0 = time.perf_counter()
    out = pipe.generate(prompts, lengths,
                        torch.Generator(dev).manual_seed(seed))
    if cuda:
        torch.cuda.synchronize(dev)
    line = {"s": round(time.perf_counter() - t0, 3),
            "launches": {c.__name__: c.launches for c in counted},
            "peak_GiB": round(torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                              3) if cuda else 0.0,
            "sha256": hashlib.sha256(b"".join(
                np.ascontiguousarray(m).tobytes() for m in out)).hexdigest()}
    return out, line


def o_forward(pipe, prompts, lengths, seed, dev):
    """One denoiser forward of the CFG-doubled micro-batch (the prompts,
    then as many empty ones) on seeded x_t at timestep O3_FWD_T, as the
    sampler calls the model but with no sampler around it: [2B, T, F]
    float32 on the host. Under a mesh of data degree 1 every rank runs
    every row."""
    import torch

    m, B = pipe.cfg.model, len(prompts)
    ids = torch.as_tensor(pipe.tokenize(list(prompts) + [""] * B)).to(dev)
    x = torch.randn((2 * B, m.max_frames, m.input_feats),
                    generator=torch.Generator(dev).manual_seed(seed),
                    device=dev)
    t = torch.full((2 * B,), O3_FWD_T, dtype=torch.long, device=dev)
    lens = torch.as_tensor(list(lengths) * 2, dtype=torch.long, device=dev)
    with torch.inference_mode():
        enc = pipe.model.encode_text(ids)
        out = pipe.model(x, t, lens, xf_proj=enc.pooled, xf_out=enc.tokens)
    return out.float().cpu()


def o_holding(pipe) -> dict:
    """What the rank holds: its parameters' elements and bytes, of which its
    experts' elements and its split FFN columns' (the leaves the model axis
    cuts), and the MoE computes its layers run."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        is_expert_param, model_dim)

    shapes = getattr(pipe, "_global_shapes", {})
    out = {"params": 0, "param_bytes": 0, "experts": 0, "split": 0}
    for n, p in pipe.model.named_parameters():
        out["params"] += p.numel()
        out["param_bytes"] += p.numel() * p.element_size()
        if is_expert_param(n):
            out["experts"] += p.numel()
        elif model_dim(n, shapes.get(n, p.shape), 2) is not None:
            out["split"] += p.numel()
    out["computes"] = sorted({m.compute for m in pipe.model.modules()
                              if hasattr(m, "model_split")})
    return out


def o_share(sd, ep, tp, pp=1) -> dict:
    """The experts' and split columns' elements a rank should hold of the
    global state ``sd`` (name -> shape): 1 / ep of each expert tensor, and
    1 / tp of w1, b1, w2 and of the FFN pairs' split leaves; of a block's,
    1 / pp (a stage's blocks)."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        is_expert_param, model_dim)

    out = {"experts": 0, "split": 0}
    for n, shape in sd.items():
        k = int(np.prod(shape)) // (pp if n.startswith("blocks_") else 1)
        cut = model_dim(n, shape, tp) is not None
        if is_expert_param(n):
            out["experts"] += k // ep // (tp if cut else 1)
        elif model_dim(n, shape, 2) is not None:
            out["split"] += k // (tp if cut else 1)
    return out


def o_join(spec, rank):
    """A phase-O rank: TF32 off, its share of the host's threads, the gloo
    group of the spec joined, the CUDA context made (all ranks at once,
    before any load in turn)."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    # the ranks share the host's cores: none oversubscribes them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
    initialize_distributed(spec["init"], spec["world"], rank,
                           backend="gloo", device=dev)
    torch.zeros(1, device=dev)
    return dev


def o1_rank(spec_path, rank):
    """One of O1's ranks: each layout of O1_LAYOUTS, the ranks loading the
    flagship's global state in turn and cutting their shards; writes
    ``o1_rank<r>.json`` (and rank 0 the motions)."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        barrier, in_turn)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = o_join(spec, rank)
    cfg = ExperimentConfig.from_dict(spec["cfg"])
    weights = torch.load(spec["params"], mmap=True, weights_only=True)
    prompts, lengths = spec["prompts"]
    res = {}
    for name, ((dp, ep, tp, sp, pp), compute, cf) in O1_LAYOUTS.items():
        mesh = generation_mesh(dp, ep, tp, sp, pp)
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, moe_compute=compute, moe_capacity_factor=cf))
        t0 = time.perf_counter()
        pipe = in_turn(lambda: GenerationPipeline(
            c, params=weights, sampler="dpm", num_inference_steps=O1_STEPS,
            micro_batch=O_MB, param_dtype="bfloat16", device=dev,
            mesh=mesh), os.path.getsize(spec["params"]))
        load_s = time.perf_counter() - t0
        barrier()
        out, line = o_generate(pipe, prompts, lengths, spec["seed"], dev)
        line.update(o_holding(pipe), load_s=round(load_s, 2))
        if rank == 0:
            np.savez(os.path.join(spec["out"], f"o1_{name}.npz"), *out)
        res[name] = line
        print(f"O1 {name} rank {rank}: {line}", flush=True)
        del pipe, out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        barrier()
    torch.distributed.destroy_process_group()
    with open(os.path.join(spec["out"], f"o1_rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def o_motions(motions):
    import torch

    return torch.from_numpy(np.concatenate([np.asarray(m) for m in motions]))


def o_compare(name, got, ref, tol, card):
    """rel RMS of two lists of motions, checked against ``tol``."""
    import torch

    a, b = o_motions(got), o_motions(ref)
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"{name}: shapes {tuple(a.shape)} vs {tuple(b.shape)} or "
          "non-finite")
    rel = rel_rms(a, b)
    print(f"[{name}] against the one-process pipeline: rel RMS {rel:.3e}, "
          f"max abs {float((a - b).abs().max()):.3e} of max "
          f"{float(b.abs().max()):.3e}; tol {tol:g} -> "
          f"{'ok' if rel <= tol else 'FAIL'} ({card})")
    check(rel <= tol, f"{name}: rel RMS {rel:.3e} > {tol:g}")
    return rel


def phase_o1(cfg, dev, card, root):
    """The flagship at full width and depth, f32 compute and bf16 weights,
    dpm with O1_STEPS steps of 16 prompts at 196 frames (micro-batch 16):
    the one-process pipeline in dense_fused and dense, then O_W ranks on
    this card over gloo in the layouts of O1_LAYOUTS, each held to the
    one-process motions of its function (dense_fused at data and seq ranks
    alone, else dense: dispatch at cf 4 drops nothing). The seq layouts cut
    T = 196 into 98 / 98 or 50 / 50 / 48 / 48 frames (``ExpertMesh.frames``)
    and run kernel 1 as its moments and apply launches around the seq
    all-reduce of kv."""
    import torch
    from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (
        pp_num_microbatches)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    j = os.path.join
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    sd = build_flagship(cfg).state_dict()
    torch.save(sd, j(root, "o1_params.pt"))
    shapes = {n: tuple(v.shape) for n, v in sd.items()}
    prompts, lengths = o_prompts(O_MB, cfg.model.max_frames)
    seed = SEED + 90
    refs, ref_lines = {}, {}

    def references():  # while the ranks start
        for compute in ("dense_fused", "dense"):
            c = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, moe_compute=compute))
            pipe = GenerationPipeline(c, params=sd, sampler="dpm",
                                      num_inference_steps=O1_STEPS,
                                      micro_batch=O_MB,
                                      param_dtype="bfloat16", device=dev)
            refs[compute], ref_lines[compute] = o_generate(
                pipe, prompts, lengths, seed, dev)
            ref_lines[compute].update(o_holding(pipe))
            del pipe
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref_lines["s"] = time.perf_counter() - t1

    spec = {"init": f"file://{j(root, 'rdv_o1')}", "world": O_W,
            "device": str(dev), "params": j(root, "o1_params.pt"),
            "out": root, "cfg": cfg.to_dict(), "prompts": [prompts, lengths],
            "seed": seed}
    with open(j(root, "o1.json"), "w") as fh:
        json.dump(spec, fh)
    t1 = time.perf_counter()
    outs = spawn_ranks([[os.path.abspath(__file__), "--o1-rank",
                         j(root, "o1.json"), str(r)] for r in range(O_W)],
                       timeout=600, meanwhile=references)
    del sd
    t_ref = ref_lines.pop("s")
    for k, v in ref_lines.items():
        print(f"[O1] one process, {k} (run while the ranks start): {v}")
    for r, (rc, out) in enumerate(outs):
        print("".join(f"[O1 rank {r}] {line}\n"
                      for line in out.splitlines() if line.strip()), end="")
    check(all(rc == 0 for rc, _ in outs),
          f"O1 ranks exited with {[rc for rc, _ in outs]}")
    res = [json.load(open(j(root, f"o1_rank{r}.json"))) for r in range(O_W)]
    n_fwd = (O1_STEPS + 1) * 2 * 2 * cfg.model.num_layers  # a micro-batch
    launches = {}
    for name, ((dp, ep, tp, sp, pp), compute, _) in O1_LAYOUTS.items():
        lines = [rr[name] for rr in res]
        # dispatch at cf 4 drops nothing: dense's function, summed apart
        ref = "dense" if ep * tp > 1 else "dense_fused"
        got = np.load(j(root, f"o1_{name}.npz"))
        o_compare(f"O1 {name}", [got[k] for k in got.files], refs[ref],
                  O1_REL, card)
        want = o_share(shapes, ep, tp, pp)
        # a seq rank runs kernel 1 as its two launches, never whole; a
        # stage its own blocks' kernels, once a microbatch
        n = n_fwd // pp * (pp_num_microbatches(
            cfg.model.pipeline_microbatches, pp) if pp > 1 else 1)
        whole, split = (0, n) if sp > 1 else (n, 0)
        expect = {"favor_qkv": whole, "favor_qkv_moments": split,
                  "favor_qkv_apply": split, "performer_epilogue": n}
        for r, line in enumerate(lines):
            check(line["launches"] == expect,
                  f"O1 {name} rank {r} launches {line['launches']}, "
                  f"expected {expect}")
            check(line["experts"] == want["experts"]
                  and line["split"] == want["split"],
                  f"O1 {name} rank {r} holds {line['experts']} expert / "
                  f"{line['split']} split elements, expected {want}")
            check(line["sha256"] == lines[0]["sha256"],
                  f"O1 {name}: rank {r}'s motions differ from rank 0's")
            want_compute = "dispatch" if compute == "dispatch" else ref
            check(line["computes"] == [want_compute],
                  f"O1 {name} rank {r} computes {line['computes']}")
        launches[name] = lines[0]["launches"]
        print(f"[O1] {name} (data {dp} x seq {sp} x pipe {pp} x expert {ep}"
              f" x model {tp}, "
              f"{compute} -> {lines[0]['computes'][0]}): every rank the "
              f"same motions; launches a rank {lines[0]['launches']}; "
              f"expert elements a rank {lines[0]['experts']} (of "
              f"{ref_lines[ref]['experts']}), split FFN elements "
              f"{lines[0]['split']} (of {ref_lines[ref]['split']}); "
              f"parameter bytes a rank {lines[0]['param_bytes']} (one "
              f"process {ref_lines[ref]['param_bytes']}); "
              f"max_memory_allocated a rank "
              f"{[ln['peak_GiB'] for ln in lines]} GiB (one process "
              f"{ref_lines[ref]['peak_GiB']}); generate "
              f"{[ln['s'] for ln in lines]} s (one process "
              f"{ref_lines[ref]['s']}; four ranks sharing one card, "
              f"collectives through the host: not a speed) ({card})")
    print(f"[O1] the flagship's state {t1 - t0:.1f} s, the one-process "
          f"references {t_ref:.1f} s while the ranks started, the ranks "
          f"{time.perf_counter() - t1:.1f} s with their start")
    return launches


def o_cli_rank(cli, argv):
    """One rank of a serve / evaluate CLI where the ranks share one card
    (O2, O4): join the group that the CLI's launch flags in ``argv`` name
    over gloo (NCCL refuses two ranks on one device), as m2_rank does, the
    host's cores split between the ranks; then the CLI's main on ``argv``,
    which finds the group made, with kernels 1 and 2 counted over its whole
    run (no warm-up), printed as it exits. Returns what main returns."""
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed)

    args = cli.build_argparser().parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // max(1, args.num_processes)))
    initialize_distributed(args.coordinator_address, args.num_processes,
                           args.process_id, backend="gloo",
                           device=args.device)
    for c in (P.favor_qkv, P.performer_epilogue):
        c.launches = 0
    res = cli.main(argv)
    print("O_LAUNCHES " + json.dumps({c.__name__: c.launches for c in (
        P.favor_qkv, P.performer_epilogue)}), flush=True)
    return res



def listening_port(log) -> int | None:
    """The port a serve CLI writing to the file ``log`` said it listens
    on, or None yet; read without moving the file's offset, at which the
    process goes on writing."""
    fd = log.fileno()
    text = os.pread(fd, os.fstat(fd).st_size, 0).decode(errors="replace")
    found = re.search(r"\[serve\] listening on http://[^:\s]+:(\d+)", text)
    return int(found.group(1)) if found else None


def phase_o2(cfg, dev, card, root):
    """tools/serve.py as O_W processes (--data_parallel 2
    --tensor_parallel 2, gloo) from the flagship's bf16 export (G1's:
    export_model of the seeded flagship), micro-batch O2_MB, answering
    O2_REQUESTS (the last spans two micro-batches), each seeded, against
    the one-process server's answers; SIGTERM to rank 0 stops every
    rank."""
    import signal

    import torch
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.tools.export import export_model
    from motiondiffusion_moe_tpu_torch.tools.serve import build_server

    j = os.path.join
    export = j(root, "o2_export")
    export_model(build_flagship(cfg), cfg, export, dtype="bfloat16",
                 normalizer=MotionNormalizer.identity(cfg.data.dim_pose))
    argv = ["--export_dir", export, "--sampler", "dpm", "--steps",
            str(O2_STEPS), "--micro_batch", str(O2_MB), "--no_denormalize",
            "--device", str(dev.type)]
    requests = []
    for n, frames, seed in O2_REQUESTS:
        texts, lengths = o_prompts(n, min(frames, cfg.model.max_frames))
        requests.append({"texts": texts, "lengths": lengths, "seed": seed})

    def one_process():  # the one-process server's answers
        srv = build_server(argv + ["--port", "0"])
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            return [_post(url + "/generate", r)[1]["motions"]
                    for r in requests]
        finally:
            srv.shutdown()
            srv.server_close()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (here, env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(O_W)]
        # rank 0 binds a port of its own choosing and prints it: a port
        # picked here first may be taken by the ranks' gloo connections
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--o2-rank", *argv,
             "--port", "0", "--data_parallel", "2",
             "--tensor_parallel", "2", "--coordinator_address",
             f"file://{j(root, 'rdv_o2')}", "--num_processes", str(O_W),
             "--process_id", str(r)],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True) for r, log in enumerate(logs)]
        failed = None
        try:
            one = one_process()  # while the ranks start
            port = health = None
            while health is None:
                port = port or listening_port(logs[0])
                try:
                    if port is not None:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
                            health = json.loads(r.read())
                        break
                except OSError:
                    pass
                if any(p.poll() is not None for p in procs):
                    failed = "a serving rank exited before rank 0 bound"
                elif time.perf_counter() - t0 > 600:
                    failed = "rank 0 did not bind within 600 s"
                if failed:
                    break
                time.sleep(1.0)
            if failed:  # the ranks' own words first
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for r, (p, log) in enumerate(zip(procs, logs)):
                    log.seek(0)
                    print("".join(f"[O2 rank {r}, exit {p.returncode}] "
                                  f"{line}\n" for line in
                                  log.read().splitlines()[-40:]), end="")
                check(False, f"O2: {failed}")
            t_up = time.perf_counter() - t0
            t1 = time.perf_counter()
            got = [_post(f"http://127.0.0.1:{port}/generate", r)
                   for r in requests]
            t_req = time.perf_counter() - t1
            procs[0].send_signal(signal.SIGTERM)
            t2 = time.perf_counter()
            for p in procs:
                p.wait(timeout=180)
            t_stop = time.perf_counter() - t2
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for p, log in zip(procs, logs):
            log.seek(0)
            outs.append((p.returncode, log.read()))
    for r, (rc, out) in enumerate(outs):
        print("".join(f"[O2 rank {r}] {line}\n"
                      for line in out.splitlines()[-6:] if line.strip()),
              end="")
    check(all(rc == 0 for rc, _ in outs),
          f"O2 serving ranks exited with {[rc for rc, _ in outs]}")
    check(health.get("ok") is True and health.get("micro_batch") == O2_MB,
          f"O2 /healthz {health}")
    n_fwd = (O2_STEPS + 1) * 2 * 2 * cfg.model.num_layers * sum(
        -(-len(r["texts"]) // O2_MB) for r in requests)
    launches = []
    for r, (_, out) in enumerate(outs):
        found = [json.loads(line.split(" ", 1)[1]) for line in
                 out.splitlines() if line.startswith("O_LAUNCHES ")]
        check(found == [{"favor_qkv": n_fwd, "performer_epilogue": n_fwd}],
              f"O2 rank {r} launches {found}, expected {n_fwd} each")
        launches.append(found[0])
    for i, ((status, body), want) in enumerate(zip(got, one)):
        check(status == 200, f"O2 request {i}: {status}")
        o_compare(f"O2 request {i} ({len(want)} prompts)",
                  [np.asarray(m, np.float32) for m in body["motions"]],
                  [np.asarray(m, np.float32) for m in want], O2_REL, card)
    print(f"[O2] serve as {O_W} processes (data 2 x model 2, gloo on this "
          f"card): up in {t_up:.1f} s, {len(requests)} requests in "
          f"{t_req:.1f} s, every rank exited 0 {t_stop:.1f} s after "
          f"SIGTERM to rank 0; launches a rank {launches[0]} ({card})")
    return launches[0]


def o3_config(cfg=None):
    """moe_big at its full width, O3_LAYERS blocks a scale (16 experts over
    8 expert partitions), computing dense both in one process and over
    ranks, in f32
    (its bf16 weights kept): in bf16 compute the seeded moe_big's motions
    move by O(1) between any two summation orders (routing flips at near
    ties, carried by the sampler), the one process's dense against its
    dense_fused included, so only f32 compute can hold the ranks to one
    process."""
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig

    cfg = cfg or ExperimentConfig.moe_big()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, moe_compute="dense", dtype="float32",
        num_layers=min(O3_LAYERS, cfg.model.num_layers)))


def seeded_state(cfg, dev, keep=None):
    """A seeded state of the denoiser drawn leaf by leaf on ``dev`` (each
    leaf from its own generator, so every process draws the same values),
    each leaf cut at once by ``keep(name, tensor)`` and stored as served in
    bf16 (the FAVOR+ projections f32): no process ever holds the whole
    model in f32. Kernels scaled by 1/sqrt(fan in), norms' scales near 1,
    biases and gates small, projections standard normal."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import is_expert_param
    from motiondiffusion_moe_tpu_torch.pipeline import serving_dtype

    with torch.device("meta"):
        shapes = [(n, tuple(p.shape)) for n, p in
                  MotionTransformer(cfg.model).named_parameters()]
    out = {}
    for i, (name, shape) in enumerate(shapes):
        g = torch.Generator(dev).manual_seed(SEED + 1000 + i)
        x = torch.randn(shape, generator=g, device=dev)
        if "projection" in name:
            pass
        elif len(shape) == 1:
            norm = name.endswith(("norm.weight", "norm_scale"))
            x = 1.0 + 0.1 * x if norm else 0.02 * x
        else:
            fan_in = (shape[1] if is_expert_param(name)
                      else int(np.prod(shape[1:])))
            x = x / math.sqrt(fan_in)
        if keep is not None:
            x = keep(name, x)
        out[name] = x.to(serving_dtype(name, torch.float32,
                                       torch.bfloat16)).contiguous()
    return out


def o3_rank(spec_path, rank):
    """One of O3's ranks: its shard of moe_big seeded on the card, dpm of 2
    prompts through the expert mesh, then one forward (o_forward); writes
    ``o3_rank<r>.json`` (and rank 0 the motions and the forward)."""
    import torch
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.parallel.distributed import barrier
    from motiondiffusion_moe_tpu_torch.parallel.mesh import generation_mesh
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = o_join(spec, rank)
    cfg = ExperimentConfig.from_dict(spec["cfg"])
    mesh = generation_mesh(1, spec["world"], 1)
    t0 = time.perf_counter()
    local = seeded_state(cfg, dev, keep=mesh.local_leaf)
    pipe = GenerationPipeline(cfg, params=local, sampler="dpm",
                              num_inference_steps=O3_STEPS, micro_batch=2,
                              param_dtype="bfloat16", device=dev, mesh=mesh)
    del local
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    load_s = time.perf_counter() - t0
    barrier()
    prompts, lengths = spec["prompts"]
    out, line = o_generate(pipe, prompts, lengths, spec["seed"], dev)
    fwd = o_forward(pipe, prompts, lengths, spec["seed"] + 1, dev)
    line.update(o_holding(pipe), load_s=round(load_s, 2),
                fwd_sha256=hashlib.sha256(fwd.numpy().tobytes()).hexdigest())
    if rank == 0:
        np.savez(os.path.join(spec["out"], "o3.npz"), *out)
        torch.save(fwd, os.path.join(spec["out"], "o3_forward.pt"))
    print(f"O3 rank {rank}: {line}", flush=True)
    torch.distributed.destroy_process_group()
    with open(os.path.join(spec["out"], f"o3_rank{rank}.json"), "w") as fh:
        json.dump(line, fh)


def phase_o3(dev, card, root, cfg=None):
    """moe_big at full width, O3_LAYERS blocks a scale, on O3_W ranks (its
    8 expert partitions), bf16 weights, f32 compute (o3_config), one
    micro-batch of
    2 prompts: one forward (o_forward) and dpm with O3_STEPS steps, each
    against the one-process moe_big of the same seeded weights (computed
    while the ranks start)."""
    import torch
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    j = os.path.join
    cfg = o3_config(cfg)
    prompts, lengths = o_prompts(2, cfg.model.max_frames)
    seed = SEED + 91
    refs, fwds, shapes = {}, {}, {}

    def references():  # while the ranks start and seed their shards
        whole = seeded_state(cfg, dev)
        shapes.update((n, tuple(v.shape)) for n, v in whole.items())
        for compute in ("dense", "dense_fused"):
            c = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, moe_compute=compute))
            pipe = GenerationPipeline(c, params=whole, sampler="dpm",
                                      num_inference_steps=O3_STEPS,
                                      micro_batch=2, param_dtype="bfloat16",
                                      device=dev)
            refs[compute] = o_generate(pipe, prompts, lengths, seed, dev)
            fwds[compute] = o_forward(pipe, prompts, lengths, seed + 1, dev)
            if compute == "dense":
                refs[compute][1].update(o_holding(pipe))
            del pipe
        del whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        refs["s"] = time.perf_counter() - t1

    spec = {"init": f"file://{j(root, 'rdv_o3')}", "world": O3_W,
            "device": str(dev), "out": root, "cfg": cfg.to_dict(),
            "prompts": [prompts, lengths], "seed": seed}
    with open(j(root, "o3.json"), "w") as fh:
        json.dump(spec, fh)
    t1 = time.perf_counter()
    outs = spawn_ranks([[os.path.abspath(__file__), "--o3-rank",
                         j(root, "o3.json"), str(r)] for r in range(O3_W)],
                       timeout=600, meanwhile=references)
    t_ref = refs.pop("s")
    ref, ref_line = refs["dense"]
    floor = rel_rms(o_motions(refs["dense_fused"][0]), o_motions(ref))
    fwd_floor = rel_rms(fwds["dense_fused"], fwds["dense"])
    print(f"[O3] moe_big at full width ({cfg.model.num_layers} blocks a "
          f"scale, "
          f"{ref_line['params']} parameters, {ref_line['experts']} of them "
          f"experts), one process: {ref_line} in {t_ref:.1f} s with the "
          f"seeding, while the ranks started; its dense_fused against its "
          f"dense: rel RMS {fwd_floor:.3e} after one forward, {floor:.3e} "
          f"after dpm{O3_STEPS}")
    for r, (rc, out) in enumerate(outs):
        print("".join(f"[O3 rank {r}] {line}\n"
                      for line in out.splitlines() if line.strip()), end="")
    check(all(rc == 0 for rc, _ in outs),
          f"O3 ranks exited with {[rc for rc, _ in outs]}")
    lines = [json.load(open(j(root, f"o3_rank{r}.json")))
             for r in range(O3_W)]
    fwd = torch.load(j(root, "o3_forward.pt"))
    a, b = fwd, fwds["dense"]
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"O3 forward: shapes {tuple(a.shape)} vs {tuple(b.shape)} or "
          "non-finite")
    rel = rel_rms(a, b)
    print(f"[O3 moe_big over 8 expert ranks, one forward at t = {O3_FWD_T}] "
          f"against the one process's dense: rel RMS {rel:.3e}, max abs "
          f"{float((a - b).abs().max()):.3e} of max "
          f"{float(b.abs().max()):.3e}; tol {O3_FWD_REL:g} -> "
          f"{'ok' if rel <= O3_FWD_REL else 'FAIL'} ({card})")
    check(rel <= O3_FWD_REL, f"O3 forward: rel RMS {rel:.3e} > "
          f"{O3_FWD_REL:g}")
    got = np.load(j(root, "o3.npz"))
    o_compare(f"O3 moe_big over 8 expert ranks, dpm{O3_STEPS}",
              [got[k] for k in got.files], ref, O3_REL + O3_FLOOR * floor,
              card)
    n_fwd = (O3_STEPS + 1) * 2 * 2 * cfg.model.num_layers
    want = o_share(shapes, O3_W, 1)
    for r, line in enumerate(lines):
        check(line["launches"] == {"favor_qkv": n_fwd,
                                   "favor_qkv_moments": 0,
                                   "favor_qkv_apply": 0,
                                   "performer_epilogue": n_fwd},
              f"O3 rank {r} launches {line['launches']}, expected {n_fwd}")
        check(line["experts"] == want["experts"],
              f"O3 rank {r} holds {line['experts']} expert elements, "
              f"expected {want['experts']}")
        check(line["sha256"] == lines[0]["sha256"]
              and line["fwd_sha256"] == lines[0]["fwd_sha256"],
              f"O3: rank {r}'s motions or forward differ from rank 0's")
    peak = [ln["peak_GiB"] for ln in lines]
    print(f"[O3] {O3_W} ranks on this card over gloo: every rank the same "
          f"motions; launches a rank {lines[0]['launches']}; parameters a "
          f"rank {lines[0]['params']} ({lines[0]['param_bytes']} bytes; "
          f"experts {lines[0]['experts']} of {ref_line['experts']}); "
          f"max_memory_allocated a rank {peak} GiB, "
          f"{sum(peak):.2f} GiB in all (one process "
          f"{ref_line['peak_GiB']}); generate {[ln['s'] for ln in lines]} s "
          f"(one process {ref_line['s']}; not a speed); the ranks "
          f"{time.perf_counter() - t1:.1f} s with their start ({card})")
    return lines[0]["launches"]


def phase_o(cfg, dev, card):
    """O1-O3 (O4 runs inside phase I, where its run lives)."""
    t = {}
    with tempfile.TemporaryDirectory(prefix="phase_o_") as root:
        t0 = time.perf_counter()
        o1 = phase_o1(cfg, dev, card, root)
        t["O1"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        o2 = phase_o2(cfg, dev, card, root)
        t["O2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        o3 = phase_o3(dev, card, root)
        t["O3"] = time.perf_counter() - t0
    print(f"[O] seconds {({k: round(v, 1) for k, v in t.items()})}")
    return {"o1": o1, "o2": o2, "o3": o3}


def o_eval_rank(out_path, argv):
    """One rank of O4's evaluate CLI (o_cli_rank); rank 0 saves the CLI's
    result to ``out_path``."""
    import torch
    from motiondiffusion_moe_tpu_torch.tools import evaluate

    res = o_cli_rank(evaluate, argv)
    if res is not None:
        torch.save(res, out_path)


O4_PROTOCOL = ["--sampler", "dpm", "--steps", "20", "--batch_size", "8",
               "--max_samples", "16", "--protocol_batch_size", "8",
               "--diversity_times", "6", "--mm_num_samples", "4",
               "--mm_num_repeats", "3", "--mm_num_times", "2",
               "--replication_times", "1", "--score_samples", "8"]


def phase_o4(root, h, card, dev="cuda"):
    """tools/evaluate.py --data_parallel 2 on phase I's run (its corpus,
    finest.tar and GloVe fixture; a few items, 1 replication) as two
    processes on this card over gloo, against the one-process run."""
    import torch
    from motiondiffusion_moe_tpu_torch.tools import evaluate

    j = os.path.join
    base = ["--run_dir", h["run_dir"], "--device", str(dev),
            "--evaluator_ckpt", j(root, "finest.tar"), "--glove_dir", GLOVE,
            *O4_PROTOCOL]
    res = {}

    def one_process():  # while the ranks start
        t0 = time.perf_counter()
        res["one"] = evaluate.main(base + ["--log_file",
                                           j(root, "o4_one.log")])
        res["s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    outs = spawn_ranks([[os.path.abspath(__file__), "--o4-rank",
                         j(root, "o4.pt"), *base, "--log_file",
                         j(root, "o4_mesh.log"), "--data_parallel", "2",
                         "--device_embeddings", "--coordinator_address",
                         f"file://{j(root, 'rdv_o4')}", "--num_processes",
                         "2", "--process_id", str(r)] for r in range(2)],
                       timeout=600, meanwhile=one_process)
    one, t_one = res["one"], res["s"]
    t_mesh = time.perf_counter() - t1
    for r, (rc, out) in enumerate(outs):
        print("".join(f"[O4 rank {r}] {line}\n" for line in
                      out.splitlines()[-4:] if line.strip()), end="")
    check(all(rc == 0 for rc, _ in outs),
          f"O4 ranks exited with {[rc for rc, _ in outs]}")
    check("--device_embeddings unsupported under a mesh" in outs[0][1],
          "O4: rank 0 did not warn that --device_embeddings takes the host "
          "path")
    launches = [[json.loads(line.split(" ", 1)[1])
                 for line in out.splitlines()
                 if line.startswith("O_LAUNCHES ")] for _, out in outs]
    check(launches[0] == launches[1] and len(launches[0]) == 1
          and min(launches[0][0].values()) > 0,
          f"O4 launches a rank {launches}")
    got = torch.load(j(root, "o4.pt"), weights_only=False)
    worst = 0.0
    for key, per_model in one["per_replication"].items():
        for model, values in per_model.items():
            a = np.asarray(got["per_replication"][key][model], np.float64)
            b = np.asarray(values, np.float64)
            rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
            worst = max(worst, rel)
            check(rel <= O4_REL, f"O4 {key} [{model}]: {a} vs {b}")
    print(f"[O4] evaluate --data_parallel 2 (two processes, gloo) against "
          f"one process: every metric of the replication within "
          f"{worst:.3e} relative (tol {O4_REL:g}); launches a rank "
          f"{launches[0][0]}; one process {t_one:.1f} s while the ranks "
          f"started, the ranks "
          f"{t_mesh:.1f} s with their start ({card})")
    return launches[0][0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name} x{count}")
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.1f} s, "
          f"cached={_build.build_info.get('cached')})")
    for line in _build.build_info.get("ptxas", []):
        if "registers" in line or "spill" in line:
            print(f"[setup] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    seconds = {}  # each phase's wall time, printed at the end
    mark = [t_start]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now

    lap("setup and build")
    a = phase_a(dev, card)
    lap("A")

    cfg = ExperimentConfig.moe_small()
    t0 = time.perf_counter()
    model = build_flagship(cfg).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[B] flagship moe_small: {n_params} parameters, seeded init + "
          f"perturbed zero-init leaves in {time.perf_counter() - t0:.1f} s")
    phase_b(cfg, model, dev)
    lap("B")

    launches, c_timings = phase_c(cfg, model, dev, card)
    model.cpu()  # back to the card in phase E
    torch.cuda.empty_cache()
    lap("C")

    d1 = phase_d1(dev, card)
    phase_d2(cfg, dev)
    d3_launches, d3_ms = phase_d3(dev, card)
    d4_launches = phase_d4(cfg, dev)
    lap("D")

    e1 = phase_e1(dev, card)
    fast = phase_e2(cfg, model, dev)
    e3_launches = phase_e3(cfg, fast, dev, card, c_timings)
    del fast
    torch.cuda.empty_cache()
    phase_e4(cfg, dev)
    lap("E")

    f1 = phase_f1(dev, card)
    phase_f2(dev)
    f3_launches = phase_f3(cfg, model, dev, card)
    lap("F")
    phase_g1(cfg, model, dev, card)
    phase_g2(dev, card)
    del model
    lap("G")
    phase_h_and_i(card, d3_ms)
    lap("H+I")
    phase_j(cfg, dev, card, c_timings, d3_ms)
    lap("J")
    phase_k(cfg, dev, card, c_timings)
    lap("K")
    phase_l(cfg, dev, card)
    lap("L")
    phase_m(cfg, dev, card)
    lap("M")
    phase_n(dev, card)
    lap("N")
    p_launches = phase_p(dev, card)
    lap("P")
    o_launches = phase_o(cfg, dev, card)
    lap("O")

    csrc = "motiondiffusion_moe_tpu_torch/csrc/"
    ops = "motiondiffusion_moe_tpu/ops/"
    models = "motiondiffusion_moe_tpu/models/"
    rows = (  # name, source, what it replaces, launches on its main path,
        #       numbers (bf16 kernels 6 and 9: cross_attention_mma.cu)
        ("favor_qkv", "favor_qkv.cu", ops + "performer_pallas.py:358",
         launches["favor_qkv"],
         a[("favor_qkv", torch.bfloat16, 196)] + (None,)),
        # kernel 1's two launches on a seq rank: launches on O1's seq 4
        # ranks (each), numbers at the first rank's 50 frames
        ("favor_qkv_moments", "favor_qkv.cu", ops + "performer_pallas.py:358",
         o_launches["o1"]["sp4"]["favor_qkv_moments"],
         a[("favor_qkv_moments", torch.bfloat16, 50)]),
        ("favor_qkv_apply", "favor_qkv.cu", ops + "performer_pallas.py:358",
         o_launches["o1"]["sp4"]["favor_qkv_apply"],
         a[("favor_qkv_apply", torch.bfloat16, 50)]),
        ("performer_epilogue", "performer_epilogue.cu",
         ops + "performer_pallas.py:657", launches["performer_epilogue"],
         a[("performer_epilogue", torch.bfloat16, 196)]),
        ("favor_qkv_bwd", "favor_qkv_bwd.cu",
         ops + "performer_pallas_bwd.py:70", d3_launches["favor_qkv_bwd"],
         d1[("favor_qkv_bwd", 196)] + (None,)),
        # kernel 3's three launches on a seq rank: launches on P1's seq 4
        # ranks (each), numbers at the first rank's 50 frames
        *((k, "favor_qkv_bwd_split.cu", ops + "performer_pallas_bwd.py:70",
           p_launches["sp4_dense"][k], d1[(k, 50)])
          for k in ("favor_qkv_bwd_kv", "favor_qkv_bwd_q",
                    "favor_qkv_bwd_k")),
        ("performer_epilogue_bwd", "performer_epilogue_bwd.cu",
         ops + "performer_pallas_bwd.py:272",
         d4_launches["performer_epilogue_bwd"],
         d1[("performer_epilogue_bwd", 196)] + (None,)),
        ("moe_dense_fused", "moe_dense_fused.cu", ops + "moe_pallas.py:64",
         e3_launches["moe_dense_fused"], e1["moe_dense_fused"]),
        ("xattn_fastlayout", "cross_attention_mma.cu",
         ops + "flash_attention.py:169", e3_launches["xattn_fastlayout"],
         e1["xattn_fastlayout"]),
        ("adaln_dense", "adaln_dense.cu", ops + "adaln_pallas.py:46",
         f3_launches["adaln_dense"], f1["adaln_dense"]),
        ("favor_attention", "favor_qkv.cu", ops + "performer_pallas.py:50",
         f3_launches["favor_attention"], f1["favor_attention"]),
        ("flash_cross_attention", "cross_attention_mma.cu",
         ops + "flash_attention.py:40", f1["flash_cross_attention_launches"],
         f1["flash_cross_attention"]),
        ("favor_attention_full", "favor_qkv.cu",
         ops + "performer_pallas.py:208", f1["favor_attention_full_launches"],
         f1["favor_attention_full"]),
        # no Pallas kernel: flax's bf16 activations, which XLA fuses
        ("silu", "activations.cu", models + "embeddings.py:172",
         launches["silu"], a["silu"]),
        ("gelu", "activations.cu", models + "attention.py:434",
         launches["gelu"], a["gelu"]),
        ("sigmoid", "activations.cu", models + "attention.py:367",
         launches["sigmoid"], a["sigmoid"]),
        # their gradient pass (jax.grad of the same flax functions), the
        # numbers of the gelu case (the largest, with the Dense bias)
        ("activation_grad", "activations.cu", models + "attention.py:434",
         d3_launches["activation_grad"], a["gelu_grad"]),
    )
    kernels = []
    for kname, src, replaces, n, (err, k_ms, p_ms, b_ms, b_by, l_ms) in rows:
        kernels.append({"name": kname, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": l_ms})
    check(all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels),
          "kernel times and launches")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s"
          f"; seconds by phase {seconds}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--m1-rank"]:  # one rank of phase M1 (ii)
        m1_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--m2-rank"]:  # one CLI rank of phase N3 (or M2)
        m2_rank(sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--n-rank"]:  # one rank of phase N1 and N2
        n_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--p-rank"]:  # one rank of phase P1 and P2
        p_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--o1-rank"]:  # one rank of phase O1
        o1_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--o2-rank"]:  # one serve CLI rank of phase O2
        from motiondiffusion_moe_tpu_torch.tools import serve
        o_cli_rank(serve, sys.argv[2:])
        sys.exit(0)
    if sys.argv[1:2] == ["--o3-rank"]:  # one rank of phase O3
        o3_rank(sys.argv[2], int(sys.argv[3]))
        sys.exit(0)
    if sys.argv[1:2] == ["--o4-rank"]:  # one evaluate CLI rank of phase O4
        o_eval_rank(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
