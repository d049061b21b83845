#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (each one failing makes the script exit non-zero):

  0. the card's name and power limit; build the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once)
     and print the build time and what ptxas reports, a line an entry
     function: its name and template arguments, registers and spills;
  1. the device time of an empty kernel launched through the forest
     library's ctypes path (the floor of every call); each forest kernel
     against its plain PyTorch version on the card: ``rfr_forest_apply``
     with the Jiagu world's forest and random forests of 64 trees at
     depth 8 and 10 (the global-memory path) at N = 1, 20, 255, 256, 257,
     9,372, 200,000 (max abs error <= 1e-6 on predictions around 1 — an
     f32 mean of at most 64 leaves — and bitwise equal to the numpy host
     oracle), the first forest kernel (one thread a row) held the same
     way and timed beside it at every N, the new one's device time no
     larger; ``rfr_capacity_sweep`` exactly equal, both
     ``log_target`` values, random +-inf bounds, M = 16 and 40, and with
     the device drain's padding (-inf rows past each scenario's m_max,
     +inf rows past its R, failures at m = 0) at M = 1, 24, 40 and
     T = 5, 24, 33, 130 (depth 6) and 64 (depth 10), and with m_max on
     a pass boundary over many scenarios, launched 20 times; each timed
     beside its plain version with CUDA events (median of 20; every
     kernel's ``ms`` is the host's and the device's time of a call, as the
     wrapper is called, and its ``device_ms`` the device's alone, of calls
     queued behind a device-side wait), the sweep's bound over the rows
     its inputs need (m at most the capacity, bound not -inf);
  2. a capacity drain over 4,096 nodes from a 24-pattern pool
     (m_max = 16): the device drain on the CUDA kernel and the host
     drain on numpy must give identical capacity tables; then the same
     over 1,024 nodes of worlds built from the diurnal-shift,
     azure-sparse and coldstart-churn traces at seeds 1-3 (the sweep's
     expf against numpy's float32 exp: a differing table is printed and
     fails);
  3. the control plane's main path: burst-storm, 24 functions, 180 s,
     1,024 target nodes, seed 0, the Jiagu scheduler, run (a) on the
     numpy engine with the host drain (the oracle), (b) on the CUDA
     engine with the host drain, (c) on the CUDA engine with the device
     drain.  (b) and (c) must equal (a) in every outcome that does not
     read the wall clock, and each kernel must have launched during its
     run; the sweep calls' shape distribution; both kernels timed at the
     largest and the median call shape of the run, the first forest
     kernel beside the new one; then (b) and (c) once more under the
     profiler for 60 simulated seconds of the scenario, with the forest
     and sweep kernels' device time in all;
  4. the LM kernels against their plain versions on the card (the three
     path functions printed; every line names the kernel that ran, which must
     be the one ``path`` names): ``flash_attention`` at
     recurrentgemma-2b's serving shapes (10 query heads, 1 kv head,
     D = 256, local window 2,048, S = 512, 1,000, 2,048, 3,000), bf16 on
     the wgmma kernel and f32 on the 3xTF32 kernel, each no slower than
     sdpa in ``ms`` and ``device_ms``, with the CUDA-core kernel held and
     timed beside both (tolerance f32 1e-5 absolute plus 1e-5 relative,
     bf16 2^-6 relative plus 2^-8 of the softmax's average of |v|, so a
     kv tile dropped or added fails); f32 bounds at the TF32 rate, the
     CUDA cores' 67 TFLOP/s beside; at small shapes (BH 8, G 2, S 333)
     for the global, chunked, softcap and non-causal masks: D = 64 in
     bf16 and f32, D = 128 in bf16, and D = 32 in bf16 (the CUDA-core
     kernel), the f32 cases also printed against a float64 evaluation
     (f32 with a softcap held against it: the plain f32 version's own
     rounding is of the tolerance's size there), and f32 softcap 20 and
     50 (q, k scaled by 4 and 8) at D = 64, 96, 128, 256 on the 3xTF32
     kernel, each held within the f32 tolerance of float64, the
     CUDA-core kernel's and the plain version's shares and the distance
     from the plain version printed beside; the ~100M training example's
     attention (``launch/train_lm.py``: BH 64 over 32 kv rows, S 512, D
     96, causal, local 512, softcap 50, f32) on the 3xTF32 kernel, held
     against float64 and timed beside the CUDA-core kernel, one compiled
     flex_attention call with the tanh softcap, the plain version and
     the bound; ``rglru_scan`` on the
     TMA path exactly equal at (1, 3000, 2560) with and without h0 and at
     (4, 1000, 2560), as is the first scan kernel (one thread a channel),
     both timed, the TMA kernel's device time no larger than the first's;
     each timed beside its plain version, and attention beside ``scaled_dot_product_attention`` with
     the same boolean mask; ``ssd_scan`` at mamba2-2.7b's serving shapes
     (B = 1, 80 heads of 64, d_state 128, one B/C group, S = 512, 1,000,
     2,048, 3,001, bf16 on the wgmma kernel and f32 on the 3xTF32
     kernel, with and without h0) against its plain version at the
     kernels' chunk of 64 (f32: 1e-4 of the largest |y| and of the
     state's norm; bf16: 2e-2), the CUDA-core kernel held and timed
     beside each tensor-core one, which must be no slower on the device,
     each one's device time printed as a share of its bound, and at S =
     3,001
     ``ops.ssd_op`` in the model's layout timed beside the kernel alone
     (the transposes around the call); ``flash_attention`` at
     deepseek-v2-236b's MLA prefill shape (BH 128, group 1, q and k of
     head dim 192, v of 128, causal global, S = 512, 1,000, 2,048, 3,000),
     bf16 on the wgmma kernel and f32 on the 3xTF32 kernel (the
     CUDA-core kernel held and timed beside each), each against its plain
     version within the same tolerances, timed beside it, sdpa with the
     same bool mask and the bound (2 (D + Dv) operations per kept pair);
     the f32 kernels against float64 at S = 512 and 3,000, and at S =
     3,000 the 3xTF32 kernel's device time no more than sdpa's;
  5. serving recurrentgemma-2b at its published width (random weights
     from a seeded generator): one ServingEngine instance, 4 slots,
     max_len 4,096, 8 requests (prompts of 512, 1,000, 2,048 and 3,000
     tokens, two each, 16 new tokens).  Every prefill must launch 8
     flash kernels, all on the tensor-core path, and 18 scan kernels, all
     on the TMA path;
     the profiled prefill prints its flash kernels' device time beside
     the CUDA-core kernel's phase-4 time, and its scan kernels' beside
     the first scan kernel's; the same requests through the plain
     versions must give prefill logits within 2e-2 of the largest
     |logit|, and the same first token wherever the top-2 margin is
     above that.  The kernels' drain decodes through the instance's
     decode step captured in a CUDA graph (one replay a decode step, the
     capture's ms printed), the plain drain eagerly (the yardstick), both
     decode rates printed; a fresh instance's captured step is held
     against the eager step on a bitwise copy of its cache for 15 greedy
     steps (the tokens equal at every step of every slot, the logits'
     largest difference printed, 0 expected, else within 2e-2 of the
     largest |logit|), each step timed; the profile also takes one
     replayed and one eager decode step.  Phases 6, 6 (b), 9 (b) and 11
     (a)-(d) serve and hold the same way;
  6. serving mamba2-2.7b at its published width and depth (phase 5's
     model freed first): the same engine, 8 requests (prompts of 512,
     1,000, 2,048 and 3,001 tokens, two each; 3,001 is prime, so the
     kernel's last chunk is ragged), 16 new tokens.  Every prefill must
     launch 64 ``ssd_scan`` kernels, all on the wgmma path, and nothing
     else; the plain run's prefill logits, SSM states and first tokens
     are held to it as in phase 5, each layer's state error printed as a
     share of its limit; then (b) deepseek-v2-236b at its published width
     (d_model 5,120, 128 heads, MLA ranks 1,536 / 512, 160 routed experts
     top-6 of d_ff 1,536, 2 shared, vocab 102,400), depth cut from 60 to
     7 layers (the dense first layer and six MoE layers), bf16 weights
     from a seeded generator (the router f32), the same engine and 8
     requests (prompts of 512-3,000 tokens): every prefill launches 7
     flash kernels, all on the wgmma path; the profiled 3,000-token
     prefill's flash outputs are held against the plain version on the
     same q, k, v; the plain run's routing is compared with the kernels'
     layer by layer (printed), and the logits and first tokens of every
     prompt whose routing agreed at its last position in every layer are
     held as in phase 5 (the others printed beside the limit);
  7. the platform facade (``repro_torch.platform``): (a) the port's
     ``smoke()`` on the card (every registered scheduler built from
     manifest dicts, 30 ticks, 8 target nodes), then the same manifests
     on engine "numpy", every scheduler's outcome equal and the
     harvesting-vs-k8s QoS gate of ``smoke()`` holding; (b) phase 3's
     scenario through ``Platform.build`` in 4 cells with admission on,
     one world shared and reseeded: jiagu on numpy (the oracle), jiagu
     on "cuda" (must launch the forest kernel) and the device-drain
     jiagu on "cuda" (must launch the sweep), equal in every outcome,
     the per-SLO-class violation rates and every node's table, with
     admission conservation within 1e-6; (c) the "learned" stack at the
     same size, one cell, its policy (the numpy init normalised over
     ``tests/data/policy_traces.jsonl``) installed from a PolicyStore in
     a temporary directory: every scored batch on the card within 1e-5
     of ``np_scores``, the same argmax wherever the top-2 margin exceeds
     that, no stale serve; the batches replayed and split into the copy
     in, the forward and the copy out with its synchronisation (CUDA
     events, medians by batch length);
  8. training: (a) the three backward kernels against their plain
     versions at the serving shapes: ``flash_attention_bwd`` at BH 10, 1
     kv head, D 256, local 2,048, causal, S = 512, 1,000, 2,048, 3,000 in
     bf16 (the tensor-core kernel of ``flash_attention_bwd_wgmma.cu``) and
     in f32 (the 3xTF32 kernel of ``flash_attention_bwd_tf32.cu``), each
     reading its forward's lse, which is held within LSE_TOL of the plain
     lse; the first kernel held on the same inputs and timed beside it;
     two calls at S = 3,000 bitwise equal; no slower than sdpa's backward
     in ``ms``), and S = 1,000 bf16 with a softcap of 50 (each of dq, dk,
     dv within BWD_TOL, its worst element printed as a share of its
     allowance; the path each ran must be the one ``bwd_path`` names),
     timed beside its plain version and sdpa's backward (forward and
     backward through ``torch.autograd.grad`` minus the forward, same
     bool mask); ``flash_attention_bwd`` at deepseek-v2-236b's MLA shape
     (BH 128, group 1, q and k of head dim 192, v of 128, causal global,
     S = 512, 1,000, 2,048, 3,000), bf16 on the wgmma kernel and f32 on
     the 3xTF32 kernel (the first kernel held and timed beside each),
     each within BWD_TOL, two calls at S = 3,000 bitwise equal, timed
     beside the plain version and sdpa's backward, with the bound (6 D +
     4 Dv operations a kept pair), and at S = 3,000 the 3xTF32 kernel's
     device time no more than sdpa's backward's; ``flash_attention_bwd``
     at the ~100M training example's shape (phase 4's) on the 3xTF32
     backward with its softcap of 50, within BWD_TOL and bitwise twice,
     timed beside the first kernel, the plain version, flex_attention's
     backward and the bound; ``rglru_scan_bwd`` exactly
     its plain reverse loop at (1,
     3,000, 2,560) with and without h0, (4, 1,000, 2,560) and (2, 1,000,
     2,562) (the one-thread-a-channel path); ``ssd_scan_bwd`` against
     ``ref.ssd_scan_bwd_ref`` at mamba2-2.7b's shapes (B 1, 80 heads of
     64, d_state 128, one group, S = 512, 1,000, 2,048, 3,001) in bf16
     and f32, without and with h0 and a gradient by the final state, then
     grouped B/C (G 2 and G 3 with 2 heads a group) and a shape off the
     served one (each gradient within SSD_TOL of its largest |value|; the
     path each ran must be the one ``bwd_path`` names: at P 64, N 128
     bf16 the wgmma kernel of ``ssd_scan_bwd_wgmma.cu`` and f32 the
     3xTF32 kernel of ``ssd_scan_bwd_tf32.cu``, the rest the first design
     of ``ssd_scan_bwd.cu``, which is held on the same inputs beside each
     tensor-core kernel; two calls at S = 3,001 bitwise equal), timed
     beside its plain version, the first design timed beside each
     tensor-core kernel at the served shape and slower than it on the
     device, each one's device time printed as a share of its bound; the
     AdamW update and gradient norm kernels
     (``csrc/adamw.cu``) at ADAMW_LEAVES, recurrentgemma-2b's embedding
     table in f32 state and deepseek-v2-236b's expert leaf in bf16: the
     update bitwise its plain version and twice, the norm within NORM_TOL
     of float64 and bitwise twice, each timed beside its plain version,
     its bound and one library call (``torch._fused_adamw_`` on the
     pre-scaled gradient; ``torch.linalg.vector_norm``);
     (b) recurrentgemma-2b, then mamba2-2.7b, at its published width and
     depth, f32 master weights and moments computed in bf16, then
     deepseek-v2-236b at its published width, depth cut from 60 to 2
     layers (the dense first layer and one MoE layer), bf16 weights,
     gradients and moments (f32 state would not fit: 85.8 GB), remat on,
     B 1, S 3,000, TokenPipeline seed 0, 8 steps of ``make_train_step``
     with the AdamWConfig the reference's ``train_loop`` builds for 8
     steps (warmup 1, cosine over 8; deepseek's moments bf16), no
     checkpoint, the step captured in a CUDA graph (``TrainStep``: a
     warm-up step and the capture, then 7 replays): every loss finite,
     the last below the first, the launches exact as the capture counts
     them (``CaptureCounts``: the warm-up step's and the captured step's
     each one step's; recurrentgemma: 8 attention backward launches a
     step, all on the wgmma path, and 18 scan backward launches; mamba2:
     64 SSD backward launches a step and 128 SSD forwards, all on the
     wgmma paths, remat recomputing each forward; deepseek: 3 flash
     forwards a step, the dense head layer's once and the MoE layer's
     twice, and 2 backwards, all on the wgmma paths at q/k 192, v 128;
     the AdamW update once a leaf a step, the norm once a step); at f32
     state the step reads bf16 held copies of the weights, which the
     AdamW kernel rewrites (``make_train_step``'s ``held=True``), each
     bitwise its weight's cast after the steps; step time, tokens/s,
     peak memory and one profiled (replayed) step, with the backward
     kernels' device time by launch, the elementwise kernels' and the
     AdamW kernels'; one eager held step under the profiler, its
     ``aten::copy_`` split by kind (``copy_split``): no weight cast; then
     the same 8 steps from the seed through the eager step that casts at
     use (``graph=False, held=False``): every loss, gradient norm and
     the final parameters' and moments' per-leaf checksums bitwise the
     graphed run's, and one more of its steps split; step time graphed
     and eager, capture ms, pool bytes, peak allocated and reserved; (c)
     one period of each at
     the same width (rec, rec, local; one SSM layer), then deepseek's
     dense layer alone and with its MoE layer (bf16 weights; the plain
     run routes every token as the kernels' run did, and the routing its
     own gates would choose is printed), S 1,024, bf16: every gradient
     leaf through the kernels against the plain versions within GRAD_TOL
     in norm, the launches exact (each attention kernel's by path), no
     leaf zero through the kernels where the plain versions' is not, and
     mamba2's A_log and dt_bias non-zero; (c3) deepseek's dense layer
     alone in f32 (weights and compute, 1.39e9 parameters): the attention
     forward and backward on the 3xTF32 kernels at MLA's q/k 192, v 128,
     every leaf and the loss within F32_GRAD_TOL (1e-4) of the plain
     versions', launches exact, none lost; (d) the
     fail/resume drill on the card at the smoke config (fail at 6,
     resume from step 4, finish at 10; a resumed run's steps 4-7 within
     rtol 1e-4 of the straight run's); (e) the policy fit at
     TrainConfig(hidden=16, epochs=30, seed=0) on the card and on the
     CPU, both timed: each step's loss within 1e-4, every train and
     holdout decision the same, save at most one a split that is a tie
     on the CPU fit (TIE_TOL), the raw agreements printed, the card's fit
     through the AdamW kernels (once a leaf and the norm once a step),
     the CPU's through neither;
  9. the serving entry points (the earlier phases' models freed first):
     (a) ``repro_torch.launch.serve`` at its defaults (jiagu,
     dual-staged, 600 s, seed 0) with the predictor on the forest kernel,
     then on numpy with the same seed: every outcome equal (density, QoS
     rate, decisions, fast, slow, real and logical cold starts, releases,
     migrations), the forest kernel launched; both runs' wall time; (b)
     gemma2-2b at its published width (26 layers, local attention in a
     window of 4,096 alternating with global, 8 query heads over 4 kv
     heads of 256, softcap 50) served as phase 5 serves, with caches of
     8,192 and prompts of 512, 3,000 and 6,000 tokens, two each (the
     6,000-token ones roll the local layers' ring cache): 26 flash
     launches per prefill, all on the wgmma path; its own bf16 rounding
     moves single logits by more than phase 5's limit, so each prefill's
     logits are held in norm, within 2e-2 of the plain run's and no
     farther from the same prefill in f32 than 1.25 times the plain run
     is (the max error printed beside phase 5's limit), the first token
     where the top-2 margin allows, and every layer's flash output in a
     6,000-token prefill against the plain version on its own q, k, v
     within the bf16 tolerance; the flash kernel at gemma2's shape (BH 8, 4
     kv heads, D 256, softcap 50, local 4,096 and global, S = 3,000 and
     6,000) timed against its plain version and its bound (sdpa takes no
     tanh softcap); (c) ``repro_torch.launch.serve_cluster``'s loop, the
     twin of ``examples/serve_cluster.py``, at published width
     (gemma2-2b and mamba2-2.7b, random f32 weights from a seeded
     generator, the example's engines: 2 replicas of 2 slots, max_len
     96, 12-token prompts, 4 new tokens) at the example's defaults (30
     ticks, release after 6) under the sinusoid and then burst-storm:
     launches exact by path (26 flash a gemma2 prefill, 64 SSD scans a
     mamba2 one, all on the tensor-core paths), every served request's
     logits (within 2e-2 in norm) and tokens (wherever the top-2 margin
     allows) held step by step against its prompt served through the
     plain versions, run eagerly; every instance's replays equal to its
     decode steps, the instances that captured and their capture ms
     printed, and a captured step held against an eager one at the
     twin's engines; one
     real cold start (``scale_up(1)``) and one logical start
     (``logical_start(1)``) of each model timed, five each;
  10. the mesh steps (``repro_torch.distributed``) on a 1x1 ("data",
     "model") NCCL mesh started from a FileStore in a temporary
     directory: (b) recurrentgemma-2b's mesh train step at full width and
     depth with its hints installed, phase 8 (b)'s seed, batches and
     AdamW settings, 3 steps: the losses within rtol 1e-5 of phase 8
     (b)'s first three and the kernels' launches a step equal to its
     (the AdamW kernels' among them, the norm over the DTensor leaves),
     and a fourth step profiled as phase 8 profiles the one-device step;
     (c) gemma2-2b at full width through ``make_prefill_step`` /
     ``make_decode_step``, a 512- and a 3,000-token prompt in turn and 16
     greedy decode steps each: the tokens and the flash launches equal
     to the one-device path's, both paths timed; (d)
     ``compressed_psum`` over the 1-rank group on (b)'s embedding
     gradient (256,000 x 2,560 f32), bitwise ``ef_quantize`` /
     ``dequantize`` on the CPU, timed; (e) the dry run
     of qwen1.5-110b x train_4k on the single- and multi-pod meshes, each
     in a subprocess on the host, and of deepseek-v2-236b and
     llama4-maverick x decode_32k on the single-pod mesh, each under the
     default hints and under ``moe_dshard`` (expert weights kept sharded
     on d, the FFN's partial sums all-reduced over "data"), the four in
     one more subprocess (all run beside phase 0's build and waited for
     before phase 1, so that no timed phase shares the host with them;
     at most 120 and 240 s): status ok, the argument GiB a device, the wire
     bytes by collective kind, the three roofline terms and the
     bottleneck; under ``moe_dshard`` the same argument bytes and the
     all-gather and all-reduce bytes apart from the default's by exactly
     the experts' gathers and partial sums worked out from the config;
     (f) deepseek-v2-236b at full width cut to 2 layers (1 dense, 1
     MoE), bf16 weights, through ``make_prefill_step`` /
     ``make_decode_step`` under the default hints and under
     ``moe_dshard``, a 512- and a 3,000-token prompt and 8 greedy decode
     steps each: the tokens and the flash launches (MLA, wgmma) equal to
     the one-device path's, all three timed; every number beside the
     card's name and power limit;
  11. the six architectures no earlier phase serves, each at its
     published width with random weights from a seeded generator, bf16
     compute, freed before the next: (a) gemma-7b (28 layers, 16 heads of
     256, MHA, f32 weights), (b) gemma3-12b (48 layers, 5 local in a
     window of 1,024 to 1 global, 16 query heads over 8 kv heads of 256,
     qk-norm, two RoPE thetas; bf16 weights; prompts of 2,048 and 3,000
     cross the window), (c) qwen1.5-110b cut from 80 layers to 8 (64
     query heads over 8 kv heads of 128, QKV bias; bf16 weights), (d)
     llama4-maverick cut from 48 layers to one period (three chunked
     layers in chunks of 8,192 and a global one without RoPE, 40 query
     heads over 8 kv heads of 128, MoE on the odd layers, 128 experts
     top-1 and a shared one; bf16 weights, 70.6 GB), served as phase 5
     serves (two prompts of 512 and of 3,000 tokens, llama4 two of 10,000
     too, past a chunk boundary, in caches of 10,240; 16 new tokens):
     every prefill launches one flash kernel a layer, all on the wgmma
     path, exactly; the prefills' logits and first tokens held against
     the plain run to phase 5's limits (llama4: where every MoE layer
     routed the last position alike, the routing differences printed;
     its 10,000-token prompts have no plain run, and the profiled one's
     flash outputs are each held against the plain version on its own
     q, k, v); (e) internvl2-2b (24 layers, f32 weights): its 256
     projected patch embeddings before prompts of 512 and 3,000 tokens
     through ``model.prefill`` and 15 greedy steps of the engine's
     ``DecodeStep`` on that cache (captured through the kernels, eager
     through the plain versions), 24 wgmma launches a prefill, every
     step's logits held, the tokens while the margins allow, and a
     captured step held against an eager one as in phase 5; (f)
     hubert-xlarge (48 non-causal layers of
     16 heads of 80, f32 weights) through ``model.forward`` on frames of
     width 512 at (1, 3,000) and (4, 1,000): 48 launches a forward on the
     wgmma kernel (head dim 80 padded to two column blocks), each forward
     through the kernels faster than through the plain versions; its own
     bf16 rounding moves the (B, S, 504) logits
     past phase 5's limit, so they are held as phase 9 (b) holds
     gemma2-2b's, in norm against the same forward in f32 (no farther from
     it than 1.25 times the plain run), and the argmax equal to the f32
     one wherever its margin is wider than 2.5 times the plain run's own
     deviation there; each model's peak memory and
     time on a line of its own; (g) the first layer of each of the six
     (gemma3-12b: its period of 6 layers) at published width, f32
     weights, bf16 compute, S 1,024: every gradient leaf through the
     kernels against the plain versions as phase 8 (c) holds them, the
     forward and backward launches exact by path (the backward on wgmma
     at D 80, 128 and 256); qwen1.5-110b's, the nearest the limit, also
     against an f32 witness (f32 compute through the plain versions),
     each bf16 run's distance from it printed by leaf; (h) the flash
     kernel at the new shapes
     (qwen's D 128 group 8 causal at S 3,000, llama4's chunked 8,192 at S
     10,000, gemma3's local 1,024 at D 256 group 2 at S 3,000, hubert's D
     80 non-causal at S 3,000), forward and backward, each held against
     its plain version (the backward bitwise over two calls) and timed
     beside it, the CUDA-core kernel, its bound and one
     scaled_dot_product_attention call (its backward) with the same
     boolean mask (the kv heads shared through `enable_gqa`); phase 11's
     time, beside the card's name and power limit;
  12. the six architectures that fit one card, trained at their
     published width as phase 8 (b) trains (``launch/train.py``'s
     ``build_state`` and ``put_batch``, ``make_train_step``, bf16 compute,
     remat on, B 1, S 3,000, TokenPipeline seed 0, 4 steps; depth,
     state dtype and learning rate from TRAIN_TABLE), each freed before
     the next: (a)
     gemma2-2b (26 layers, f32 state), (b) gemma-7b (28 layers, bf16
     state), (c) gemma3-12b cut from 48 layers to 30, five whole periods
     (bf16), (d) qwen1.5-110b cut from 80 to 4 (bf16), (e) internvl2-2b
     (24 layers, its 256 patch positions and 2,744 text tokens, f32) and
     (f) hubert-xlarge (48 non-causal layers on frames, f32); qwen at a
     learning rate of 3e-5, where 3e-4 overshoots, the others at AdamW's
     default 3e-4: every loss
     finite, the last below the first, the peak within 72 GiB, the launches
     exact and every attention kernel on the wgmma path, no scan launched,
     the AdamW update once a leaf and the norm once a step;
     each step's loss, grad norm, lr and time, the state's GB and the peak
     printed, each through the captured step as phase 8 (b), one more
     step of each profiled, then 2 eager steps on its state for the eager
     step's time;
     (g) hubert-xlarge through ``train_loop`` for 3 steps with (f)'s AdamW
     settings (captured): its losses bitwise (f)'s first three, the
     launches exact;
     (h) gemma2-2b's period (local then global, softcap 50) at S 1,024:
     every gradient leaf through the kernels against the plain versions as
     phase 8 (c) holds them; (i) the flash kernel at the shapes (a)-(f)
     give it at S 3,000 that no earlier phase holds there (gemma2-2b's
     local 4,096 and global with its softcap of 50, gemma-7b's 16 heads
     of 256, internvl2-2b's 16 over 8 of 128), forward and backward
     against the plain versions, the backward bitwise over two calls,
     each direction timed beside the plain version, the CUDA-core kernel,
     the bound and the library (sdpa, or with gemma2-2b's softcap one
     compiled flex_attention call, its backward included), gemma2-2b's
     softcapped forward's device time below flex_attention's at both
     masks, its share of the bound printed; then gemma2-2b's attention
     split apart (``flash_split``): at its local 4,096 mask, S 3,000, the
     kernels as called, the same inputs without the softcap, and the
     softcap at 16 heads over 8, each direction's device time against its
     bound;
     phase 12's time, beside the card's name and power limit;
  13. the twin of the ~100M training example (``launch/train_lm.py``,
     ``examples/train_lm.py``'s: gemma2-2b cut to 10 layers of d 768, 8
     query heads over 4 kv heads of 96, softcap 50, byte vocabulary,
     window 512, f32 weights and compute, B 8, S 512, AdamW at lr 6e-4)
     at its default size through ``train_lm.run``, the step captured in
     a CUDA graph: 24 steps with a checkpoint every 12 into a temporary
     directory, the launches exact
     (each step 20 attention forwards under remat and 10 backwards, all
     on the 3xTF32 kernels, none on the CUDA cores; the AdamW update once
     a leaf, the norm once); a run resumed from
     the step-12 checkpoint, its losses within rtol 1e-4 of the straight
     run's; the 24 steps again from the seed through the eager step, the
     losses and the final state's per-leaf checksums bitwise the graphed
     run's; 3 steps through the plain versions from the same seed, each
     loss within 1e-4 of the kernels'; step time graphed and eager,
     tokens/s, peak memory and the losses; one step profiled, beside the
     attention time of the
     step's launches at phase 4's and 8's kernel times and at the
     CUDA-core kernels' (the route the parent took); phase 13's time;
  14. mamba2-2.7b computed in f32 at its published width and depth (64
     layers, d 2,560, 80 heads of 64, d_state 128, one group, vocab
     50,280; ``dtype="float32"``, as ``examples/train_lm.py`` sets its
     config), every SSD scan and backward on the 3xTF32 kernels: (a) one
     forward and backward at B 1, S 3,000, remat, through the kernels
     and through the plain versions on the same seeded weights and
     batch, the loss within 1e-5 relative and every gradient leaf within
     1e-3 in norm (the worst printed as a share of it), none zero
     through the kernels where the plain one is not, the launches exact
     (128 forwards, 64 backwards, all "tf32"); (b) one SSM layer at S
     1,024 the same way within F32_GRAD_TOL (1e-4), A_log and dt_bias
     non-zero; (c) 4 train steps on f32 weights and moments (phase 8
     (b)'s route, captured), the launches exact (128 forwards and 64
     backwards a step on "tf32", none on "simt" or "wgmma"), step time,
     tokens/s, peak memory, one step profiled with the SSD kernels'
     device time beside the rest, 2 eager steps for the eager step's
     time; (d) two prompts each of 512 and 3,001 tokens served
     by one instance, 16 greedy tokens decoded through its captured
     step: the last-position logits within 1e-3 of the largest |logit|
     and every layer's final state within 1e-3 in norm of the plain
     run's (where not, both against a float64 plain run, the kernels' no
     farther than 1.25 times the plain f32 run's), a captured decode
     step bitwise the eager one over 16 steps; phase 14's time;
  15. the f32 flash path's times and the f32 attention backward's on
     lines of their own; one JSON line describing the five kernels and
     the three backward kernels (flash attention's entry is the bf16
     serving path's kernel, with the f32 path's under "f32" and the MLA
     shape's under "mla", its launches phase 6 (b)'s; the SSD
     scan's is the wgmma kernel, the RG-LRU scan's the TMA kernel; each
     redesigned kernel carries the first kernel's times beside its own,
     the backward kernels' too (the attention backward's entry is the
     wgmma kernel, the 3xTF32 one under "f32"; the SSD backward's the
     wgmma kernel); the backward kernels' launches are phase 8 (b)'s;
     the attention backward's MLA shape under "mla", its launches by
     path deepseek-v2's phase 8 (b) run's; the f32 MLA forward and
     backward, on the 3xTF32 kernels, under each "mla" entry's "f32",
     their launches phase 8 (c3)'s, each with sdpa's time, the bound and
     the CUDA-core kernel's time; phase 9's launches: the serve
     driver's forest launches under "serve_launches", gemma2-2b's flash
     launches and its shapes' times under "gemma2", the twin's launches
     by load under "cluster_launches"; phase 10's launches on the mesh
     under "mesh_launches"; phase 11's launches by architecture and path
     under "phase11", in the attention's entry with the times of (h) and
     in the attention backward's from (g); phase 12's launches by run in
     each LM kernel's entry under "phase12_launches"; the 3xTF32
     kernels with a softcap at the training example's shape, forward and
     backward, as entries of their own, their launches phase 13's; the
     AdamW update and gradient norm as entries of their own, timed at
     recurrentgemma-2b's embedding table (deepseek-v2-236b's expert leaf
     under "bf16"), their launches phase 8 (b)'s recurrentgemma-2b run's,
     by phase under "launches_by_phase" (8 b, 8 e, 13), "mesh_launches"
     and "phase12_launches"; the f32 SSD scan and backward on the 3xTF32
     kernels under the SSD entries' "f32", their times and the first
     designs' at S 3,001 (phases 4 and 8 (a)), their launches phase 14's
     by part), then the device line.

Exits non-zero and prints no result when there is no CUDA card or the
port is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = CSRC + "rfr_inference.cu"
#: the source of each LM kernel's entry in the kernels line: the kernel
#: that serves it (flash attention in bf16 at D = 256, the SSD scan in
#: bf16 at P = 64, N = 128); the f32 attention kernel rides in flash
#: attention's entry under "f32"
SOURCES = {"flash_attention": "flash_attention_wgmma.cu",
           "flash_attention f32": "flash_attention_tf32.cu",
           "rglru_scan": "rglru_scan.cu", "ssd_scan": "ssd_scan_wgmma.cu"}
#: the TPU kernels these replace (def lines)
REPLACES = {"rfr_forest_apply": "src/repro/kernels/rfr_inference.py:72",
            "rfr_capacity_sweep": "src/repro/kernels/rfr_inference.py:130",
            "flash_attention": "src/repro/kernels/flash_attention.py:77",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:39",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65"}
#: NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside tensor cores,
#: bf16 and TF32 dense tensor-core rates.  The matrix products of f32
#: inputs (attention, the SSD scan) are bounded at the TF32 rate: a
#: kernel that computes them on the tensor cores at f32 accuracy (3xTF32)
#: can beat the CUDA cores' 67 TFLOP/s, so that figure is no bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
#: flash attention against its plain version, elementwise: f32 within
#: 1e-5 absolute plus 1e-5 relative (online against materialised
#: softmax, other summation order); bf16 within 2^-6 of |out| (two to four bf16 ulps:
#: the kernel and the plain version each round the output once) plus
#: 2^-8 of the same softmax's average of |v| (the kernel rounds each p to
#: bf16, a relative error of at most 2^-9, where the plain version keeps
#: p in f32).  At the serving shapes an output averages some 2,000 values
#: of |v| about 0.8 to |out| about 0.03, so one kv tile of 32 keys
#: dropped or added moves outputs by many times that
ATTN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -8)}
#: the f32 softcap sweep's head dims, all on the 3xTF32 kernels
TF32_SOFTCAP_DIMS = (64, 96, 128, 256)
#: the ~100M training example (examples/train_lm.py, its twin
#: launch/train_lm.py): gemma2-2b cut to 10 layers of d 768, 8 query heads
#: over 4 kv heads of 96, window 512, f32, B 8, S 512.  Its attention is
#: (BH, G, S, D) with gemma2's softcap; phase 13 trains it for TRAIN_LM_STEPS
#: steps with a checkpoint every TRAIN_LM_STEPS / 2 and holds
#: TRAIN_LM_PLAIN_STEPS of them against the plain versions
TRAIN_LM_ATTN = (64, 2, 512, 96)
TRAIN_LM_KW = dict(causal=True, kind="local", window=512, softcap=50.0)
TRAIN_LM_STEPS = 24
TRAIN_LM_PLAIN_STEPS = 3
TRAIN_LM_TOL = 1e-4
#: deepseek-v2-236b's MLA prefill: 128 heads, q and k of head dim 128 +
#: 64 (nope + rope), v of head dim 128, causal global attention
MLA_HEADS, MLA_QK_DIM, MLA_V_DIM = 128, 192, 128
#: recurrentgemma-2b's local layers: MQA, head dim 256, window 2,048
SERVE_ARCH = "recurrentgemma-2b"
SERVE_PROMPTS = (512, 1000, 2048, 3000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 4, 4096, 16
#: the graph-against-eager hold of every served architecture: greedy
#: decode steps each way from bitwise-equal caches
HOLD_STEPS = SERVE_MAX_NEW - 1
#: phase 5, kernels against plain on the whole model in bf16: the
#: prefill's last-position logits within 2e-2 of the largest |logit|,
#: and each recurrent or SSM layer's final state within 2e-2 in norm
#: (phases 5 and 6)
LOGIT_TOL = 2e-2
#: phase 9 (b), gemma2-2b: on random weights at published width its own
#: bf16 rounding moves its logits (|logit| averaging 20.7 under the cap of
#: 30) by 2.4-2.5 from the same prefill in f32, 8% of the largest |logit|
#: and four times LOGIT_TOL of it, so the kernels run is held in norm:
#: within LOGIT_TOL of the plain run, and no farther from f32 than
#: WITNESS_RATIO times the plain run is (measured 0.99-1.02)
WITNESS_RATIO = 1.25
#: mamba2-2.7b: 80 SSM heads of 64, d_state 128, one B/C group; the SSD
#: kernel against its plain version at the kernel's chunk: f32 1e-4 of
#: the largest |y| and of the state's norm (the same arithmetic summed in
#: other orders), bf16 2e-2 (both compute in f32 from the same bf16
#: values, y is rounded to bf16 once)
SSM_ARCH = "mamba2-2.7b"
SSM_PROMPTS = (512, 1000, 2048, 3001)
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: phase 6 (b): deepseek-v2-236b at its published width, depth cut from
#: 60 layers (470 GB of bf16 weights) to the dense first layer and six
#: MoE layers (about 50 GB), served as phase 5 serves
MOE_ARCH = "deepseek-v2-236b"
MOE_LAYERS = 7
#: phase 8 (b): deepseek-v2-236b trained at its published width, depth
#: cut to the dense first layer and one MoE layer (5.36e9 parameters:
#: 42.9 GB of bf16 weights, gradients and two moments); (c) its dense
#: layer alone (c1) and both layers (c2)
MOE_TRAIN_LAYERS = 2
#: phase 8: recurrentgemma-2b and mamba2-2.7b trained at full width and
#: depth on the serving shape's longest prompt (past recurrentgemma's
#: 2,048 window; 46 whole chunks of 64 and a ragged one of 56 for the SSD
#: scan), B 1; (c) one period of each at the same width, S 1,024
TRAIN_ARCH = SERVE_ARCH
TRAIN_ARCHS = (SERVE_ARCH, SSM_ARCH)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 3000, 1, 8
PERIOD_SEQ = 1024


class Trained(NamedTuple):
    """How phase 8 (b) and phase 12 train an architecture at its
    published width: its depth (0: the config's own), the dtype of its
    weights, gradients and moments, and AdamW's peak learning rate."""
    depth: int = 0
    dtype: str = "float32"
    lr: float = 3e-4            # AdamWConfig's default


#: each architecture trained at its published width.  State is 16 bytes a
#: parameter in f32 and 8 in bf16, which each model takes where f32 would
#: not fit one card; depths are cut by whole periods, only where the peak
#: would pass TRAIN_PEAK_GIB
TRAIN_TABLE = {
    "recurrentgemma-2b": Trained(),
    "mamba2-2.7b": Trained(),
    # the dense first layer and one MoE layer: 5.36e9 parameters
    MOE_ARCH: Trained(MOE_TRAIN_LAYERS, "bfloat16"),
    "gemma2-2b": Trained(),
    "internvl2-2b": Trained(),
    "hubert-xlarge": Trained(),
    # full depth: 8.54e9 parameters, a 69.6 GiB peak
    "gemma-7b": Trained(0, "bfloat16"),
    # 30 of 48 layers, five whole periods of 5 local layers and 1 global:
    # at 36 (six periods) the step ran out of the card's memory past 71.6
    # GiB allocated
    "gemma3-12b": Trained(30, "bfloat16"),
    # 4 of 80 layers: 1.36e9 parameters a layer, 2.49e9 in the untied
    # embedding and head; at 5 the step ran out of memory past 74 GiB
    # allocated.  At d_model 8,192 and d_ff 49,152 Adam's first full step
    # at 3e-4 (warmup 1) overshoots: with 2 layers the loss rose 3.5x,
    # through the plain versions as much, and with 1 layer as much in f32
    # state as in bf16; at 3e-5 the last loss is below the first
    "qwen1.5-110b": Trained(4, "bfloat16", 3e-5),
}
TRAIN_PEAK_GIB = 72

#: phase 8 (a): the SSD backward kernel's gradients, in the order it
#: returns them, each held to SSD_TOL of its largest |value|
SSD_GRADS = ("dx", "ddA", "ddt", "dB", "dC", "dh0")
#: the attention backward against its plain version (the same f32
#: formula summed in other orders): each gradient within (relative, of
#: the tensor's largest |value|); bf16 gradients may round to
#: neighbouring bf16 values (2^-7 apart), f32 ones differ in the sums'
#: order.  A key tile of 32 dropped or added moves a row's dq by a few
#: hundredths of the largest
BWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 1e-4)}
#: the bf16 forward's row log-sum-exp (which the tensor-core backward
#: reads) against the plain one, absolute: the same f32 scores summed in
#: another order; one key of a 2,048-key window dropped or added moves a
#: row's lse by about 5e-4
LSE_TOL = 1e-4
#: phase 8 (c): each gradient leaf through the kernels against the plain
#: versions, relative in norm, bf16 compute: the forward kernel rounds p
#: to bf16 before P.V where the plain version keeps f32, which moves the
#: activations by ~2^-9 and every gradient after them
GRAD_TOL = 5e-2
#: phase 8 (c3): the same in f32 compute, where the kernels (3xTF32) and
#: the plain versions compute the same f32 function summed in other
#: orders: the f32 tolerance the CPU tests hold the port's gradients to
#: against the JAX model
F32_GRAD_TOL = 1e-4
#: phase 8 (e): two candidates whose scores on the CPU fit lie within
#: this share of the larger (a few f32 ulps at the fixture's scores) are a
#: tie that rounding breaks; at most MAX_TIE_FLIPS decisions a split may
#: differ so
TIE_TOL = 1e-6
MAX_TIE_FLIPS = 1
#: phase 2's second drain: device-drain capacity tables against the numpy
#: host drain on worlds of other traces and seeds (the sweep's expf and
#: numpy's float32 exp differ by an ulp on many inputs)
SETTLE_TRACES = ("diurnal-shift", "azure-sparse", "coldstart-churn")
SETTLE_SEEDS = (1, 2, 3)
SETTLE_NODES = 1024
PRED_TOL = 1e-6
#: phase 1's forest batch sizes: one row, the control plane's median call,
#: either side of a block of the first kernel (256 rows), its largest call,
#: and a large batch
FOREST_N = (1, 20, 255, 256, 257, 9372, 200_000)
#: GPU clock cycles of the wait a timed call is queued behind: about 2 ms
#: at the H100's 1.98 GHz boost clock, far above a kernel wrapper's host
#: time
QUEUE_CYCLES = 4_000_000
SCENARIO = dict(n_functions=24, duration_s=180, target_nodes=1024, seed=0)
#: phase 3's profiled reruns run the scenario for 60 simulated seconds,
#: not 180: the profiler's processing of the whole device-drain run's
#: device events took 77 s of host time beside the run's 20.7 s
PROFILED_S = 60
#: phase 7 (b): the control plane's own size through Platform.build,
#: sharded into cells, admission on; per-function conservation of
#: admitted = served + dropped + queued within CONSERVATION_TOL
PLATFORM_CELLS = 4
CONSERVATION_TOL = 1e-6
#: phase 7 (c): the learned scorer's policy is the numpy init (hidden
#: width, seed) normalised over the checked-in decision traces, the
#: same dict the CPU tests serve; its scores on the card within
#: SCORE_TOL of np_scores (f32 products, TF32 off)
POLICY_TRACES = "tests/data/policy_traces.jsonl"
POLICY_HIDDEN, POLICY_SEED = 16, 3
SCORE_TOL = 1e-5
DRAIN_NODES = 4096
DRAIN_M_MAX = 16
N_PATTERNS = 24


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise PhaseFailed(what)


def _event_ms(fn, queued: bool) -> float:
    """One call of `fn` timed by CUDA events (see ``time_ms``)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Median time of one call, by CUDA events, after a warm-up.

    By default the card idles while the host runs the call (a wrapper's
    checks, allocation, the ctypes call, the launch), so the time is the
    host's and the device's together, as a caller meets it: every
    kernel's ``ms``; a call of a few microseconds on the card reads some
    20-40 us.  With `queued` each call is enqueued behind a device-side
    wait of QUEUE_CYCLES, so the start event fires after the host has
    enqueued the whole call and the events time the device's work alone:
    every kernel's ``device_ms``.  A call whose host part outlasts the
    wait (a plain version's Python loop) reads its host time either
    way."""
    import torch
    fn()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(fn, queued) for _ in range(reps))


def time_pair_ms(fn_a, fn_b, reps: int = 20,
                 queued: bool = False) -> tuple[float, float]:
    """``time_ms`` of two calls that are compared, taken in turn (a, b, a,
    b, ...): the medians of each.  The host's part of a call varies with
    what else the machine's shared cores run, and a busy stretch that
    fell on one call's reps alone would decide a comparison of host
    times; taken in turn, both calls meet the same stretches."""
    import torch
    fn_a()
    fn_b()
    torch.cuda.synchronize()
    a, b = [], []
    for _ in range(reps):
        a.append(_event_ms(fn_a, queued))
        b.append(_event_ms(fn_b, queued))
    return statistics.median(a), statistics.median(b)


def forest_bytes(feat) -> int:
    t, nn = feat.shape
    return t * nn * 8 + t * (nn + 1) * 4


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time on an H100 SXM, ms, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forest_bound(n: int, f: int, feat):
    t, nn = feat.shape
    depth = (nn + 1).bit_length() - 1
    # inputs read once, output written once; per (row, tree) D compares
    # and one add, per row one divide
    return bound(n * f * 4 + forest_bytes(feat) + n * 4,
                 n * t * (depth + 1) + n)


def sweep_rows(bounds, caps):
    """(rows the inputs need, padded rows): a scenario's capacity c is
    its first failing m (0-based), so the rows with m <= c decide it; of
    those, a row whose bound is -inf fails without a descent."""
    import torch
    s, m, r = bounds.shape
    m_idx = torch.arange(m, device=bounds.device)[None, :, None]
    upto = (m_idx <= caps.to(bounds.device)[:, None, None]).expand(s, m, r)
    return int((upto & (bounds != float("-inf"))).sum()), s * m * r


def sweep_bound(shape, feat, log_target: bool, rows: int):
    """The least time for the sweep over `rows` descended rows: each read
    once (features and bound), the forest read once, the capacities
    written once; per row T*(D+1) operations of the descent and mean, a
    compare, and the exp under log_target."""
    s, m, r, f = shape
    t, nn = feat.shape
    depth = (nn + 1).bit_length() - 1
    per_row = t * (depth + 1) + 1 + 1 + (1 if log_target else 0)
    return bound(rows * f * 4 + rows * 4 + forest_bytes(feat) + s * 4,
                 rows * per_row)


def v1_forest(x, feat, thr, leaf):
    """The first forest kernel of csrc/rfr_inference.cu (one thread a
    row) called directly, so that it can be held and timed beside the
    wrapper's; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build, ref
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    err = _build.load("rfr_inference").rfr_forest_apply_v1(
        x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], feat.shape[0],
        ref.forest_depth(feat), x.device.index or 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rfr_forest_apply_v1")
    return out


def empty_launch_ms() -> float:
    """Device time of an empty kernel launched through the forest
    library's ctypes path, queued as every ``device_ms`` is: the floor
    no kernel call can pass."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load("rfr_inference")
    return time_ms(lambda: _build.check_launch(
        lib.rfr_empty(torch.cuda.current_stream().cuda_stream), "rfr_empty"),
        queued=True)


def hold_forest(x, feat, thr, leaf, want=None, plain_timed=True):
    """rfr_forest_apply against its plain version (and, given `want`,
    bitwise against the numpy oracle's predictions) on these inputs, the
    first kernel held beside it the same way; both kernels timed, the new
    one's device time no larger than the first's (the narrowest margin,
    at 200,000 rows of the depth-10 forest in device memory, was
    1.08-1.11x over four runs on an H100 80GB HBM3 at 700 W; every other
    shape 1.7x or more).  Returns a dict of the
    measurements (the plain version's time and the bound with
    `plain_timed`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_forest_apply
    what = f"rfr_forest_apply N={x.shape[0]} T={feat.shape[0]}"
    got = rfr_forest_apply(x, feat, thr, leaf)
    old = v1_forest(x, feat, thr, leaf)
    plain = ref.rfr_forest_ref(x, feat, thr, leaf)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    v1_err = float((old - plain).abs().max())
    check(err <= PRED_TOL and v1_err <= PRED_TOL,
          f"{what}: {err} (first kernel {v1_err})")
    out = {"max_abs_err": err, "v1_err": v1_err}
    if want is not None:
        out["numpy_bitwise"] = (np.array_equal(got.cpu().numpy(), want),
                                np.array_equal(old.cpu().numpy(), want))
        check(all(out["numpy_bitwise"]), f"{what} != numpy (new, first: "
              f"{out['numpy_bitwise']})")
    out["ms"] = time_ms(lambda: rfr_forest_apply(x, feat, thr, leaf))
    out["device_ms"] = time_ms(lambda: rfr_forest_apply(x, feat, thr, leaf),
                               queued=True)
    out["v1_ms"] = time_ms(lambda: v1_forest(x, feat, thr, leaf))
    out["v1_device_ms"] = time_ms(lambda: v1_forest(x, feat, thr, leaf),
                                  queued=True)
    check(out["device_ms"] <= out["v1_device_ms"],
          f"{what}: device {out['device_ms']:.4f} ms, slower than the first "
          f"kernel's {out['v1_device_ms']:.4f} ms")
    if plain_timed:
        out["plain_ms"] = time_ms(lambda: ref.rfr_forest_ref(x, feat, thr,
                                                             leaf))
        out["bound_ms"], out["bound_by"] = forest_bound(x.shape[0],
                                                        x.shape[1], feat)
    return out


def hold_sweep(x, bounds, feat, thr, leaf, log_target):
    """rfr_capacity_sweep against its plain version (exactly) on these
    inputs, and both timed: (max abs error, kernel ms, kernel device ms,
    plain ms, bound ms, bound by, rows needed, padded rows)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_capacity_sweep
    args = (x, bounds, feat, thr, leaf)
    got = rfr_capacity_sweep(*args, log_target=log_target)
    plain = ref.rfr_capacity_sweep_ref(*args, log_target=log_target)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(err == 0, f"rfr_capacity_sweep {tuple(x.shape)}: {err}")
    rows, padded = sweep_rows(bounds, plain)
    return (err,
            time_ms(lambda: rfr_capacity_sweep(*args,
                                               log_target=log_target)),
            time_ms(lambda: rfr_capacity_sweep(*args, log_target=log_target),
                    queued=True),
            time_ms(lambda: ref.rfr_capacity_sweep_ref(
                *args, log_target=log_target)),
            *sweep_bound(tuple(x.shape), feat, log_target, rows),
            rows, padded)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def outcome(res, sim) -> dict:
    """Every outcome of a run that does not read the wall clock."""
    s, c = res.sched, res.scaling
    return {
        "density": res.density,
        "qos_violation_rate": res.qos_violation_rate,
        "requests": res.requests,
        "violated_requests": res.violated_requests,
        "nodes_peak": res.nodes_peak,
        "sched": (s.decisions, s.fast, s.slow, s.failed, s.instances_placed),
        "scaling": (c.real_cold_starts, c.logical_cold_starts, c.releases,
                    c.evictions, c.migrations),
        # the admission axis (empty without a controller)
        "class_requests": dict(res.class_requests),
        "class_violation_rates": {k: v / res.class_requests[k]
                                  for k, v in res.class_violations.items()},
        "dropped_requests": res.dropped_requests,
        "queue_depth_peak": res.queue_depth_peak,
        # node ids come from a process-wide counter: compare in id order
        "tables": [sorted((fn, e.capacity)
                          for fn, e in sim.cluster.nodes[i].table.items())
                   for i in sorted(sim.cluster.nodes)],
    }


def device_drain_jiagu(ctx):
    """Jiagu with a device-drain PredictionService already attached (the
    Simulation keeps a service it finds instead of attaching its own)."""
    import repro_torch.core as core
    sched = core.JiaguScheduler(ctx.cluster, ctx.store, ctx.qos,
                                ctx.predictor, m_max=ctx.m_max)
    sched.attach_service(core.PredictionService(
        ctx.predictor, ctx.store, ctx.qos, ctx.specs,
        core.EngineConfig(m_max=ctx.m_max, retrain_every=ctx.retrain_every,
                          learned_shape_margin=ctx.learned_shape_margin,
                          drain="device"),
        schema=ctx.schema_version))
    return sched


class Recorder:
    """Keeps the largest inputs each kernel wrapper was given, so the
    kernels can be checked and timed at the shapes the main path used.
    Wraps the names ``kernels.ops`` calls; the wrappers still count their
    own launches."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = (ops.rfr_forest_apply, ops.rfr_capacity_sweep)
        self.forest = None      # (x, feat, thr, leaf)
        self.sweep = None       # (x, bounds, feat, thr, leaf, log_target)
        self.sweep_by_shape = {}  # shape -> its first call's inputs
        self.forest_calls = []
        self.sweep_calls = []
        apply_fn, sweep_fn = self.orig

        def rec_apply(x, feat, thr, leaf):
            self.forest_calls.append(x.shape[0])
            if x.is_cuda and (self.forest is None
                              or x.shape[0] > self.forest[0].shape[0]):
                self.forest = (x.clone(), feat, thr, leaf)
            return apply_fn(x, feat, thr, leaf)

        def rec_sweep(x, bounds, feat, thr, leaf, *, log_target=False):
            shape = tuple(x.shape)
            self.sweep_calls.append(shape)
            if x.is_cuda and shape not in self.sweep_by_shape:
                self.sweep_by_shape[shape] = (x.clone(), bounds.clone(), feat,
                                              thr, leaf, log_target)
                if (self.sweep is None
                        or x.numel() > self.sweep[0].numel()):
                    self.sweep = self.sweep_by_shape[shape]
            return sweep_fn(x, bounds, feat, thr, leaf,
                            log_target=log_target)

        ops.rfr_forest_apply, ops.rfr_capacity_sweep = rec_apply, rec_sweep

    def close(self):
        self.ops.rfr_forest_apply, self.ops.rfr_capacity_sweep = self.orig


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()      # one nvcc per source, all at once
    print(f"phase0 build: {time.perf_counter() - t0:.2f} s "
          f"(compiled: {built or 'none, cached'})")
    for name in _build.SOURCES:
        for line in ptxas_lines(_build.build_log(name)):
            print(f"phase0 ptxas {name} {line}")
        _build.load(name)


def _kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name (``flash_wgmma_kernel<256,256,32,0>``), past an anonymous
    namespace's."""
    i, name = (3 if mangled.startswith("_ZN") else 2), None
    while name is None:
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            return mangled
        j = i + m.end()
        ident, i = mangled[j:j + int(m.group())], j + int(m.group())
        if not ident.startswith("_GLOBAL__N"):
            name = ident
    rest = mangled[i:]
    args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 1]) \
        if rest.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_lines(log: str) -> list:
    """nvcc -Xptxas -v's report as one line an entry function: its name
    (``_kernel_name``), registers, and spill stores and loads."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name is not None:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} "
                         f"registers; {spill}")
            name = None
    return lines


def _random_forest(rng, t, depth, f):
    nn = (1 << depth) - 1
    return (rng.integers(0, f, (t, nn)).astype("int32"),
            rng.standard_normal((t, nn)).astype("float32"),
            rng.standard_normal((t, nn + 1)).astype("float32"))


def phase1_kernels(world):
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import (forest_path,
                                                   rfr_capacity_sweep)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = world.predictor.model.arrays
    X_world, _ = world.predictor.dataset()
    forests = [("world T=24 D=8", (a.feat, a.thr, a.leaf), X_world.shape[1]),
               ("random T=64 D=8", _random_forest(rng, 64, 8, 31), 31),
               ("random T=64 D=10", _random_forest(rng, 64, 10, 31), 31)]
    print(f"phase1 empty kernel through the same ctypes path: device "
          f"{empty_launch_ms():.4f} ms")
    timings = {}
    for name, arrays, f in forests:
        oracle = core.RandomForestRegressor(device=dev).load_arrays(*arrays)
        fo = oracle.device_arrays()
        where = forest_path(fo[0].shape[0], ref.forest_depth(fo[0]))
        for n in FOREST_N:
            if name.startswith("world"):
                x = X_world[rng.integers(0, len(X_world), n)]
            else:
                x = rng.standard_normal((n, f)).astype(np.float32)
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            m = hold_forest(xt, *fo, want=oracle.predict(x, engine="numpy"),
                            plain_timed=n == max(FOREST_N))
            print(f"phase1 rfr_forest_apply {name} ({where}) N={n}: "
                  f"max_abs_err={m['max_abs_err']:.3g} numpy_bitwise="
                  f"{m['numpy_bitwise'][0]} (first kernel "
                  f"{m['numpy_bitwise'][1]}), kernel {m['ms']:.4f} ms "
                  f"(device {m['device_ms']:.4f} ms), first kernel "
                  f"{m['v1_ms']:.4f} ms (device {m['v1_device_ms']:.4f} ms, "
                  f"{m['v1_device_ms'] / m['device_ms']:.2f}x the new)")
            if n == max(FOREST_N):
                timings[f"rfr_forest_apply {name} N={n}"] = (
                    m["ms"], m["device_ms"], m["plain_ms"], m["bound_ms"],
                    m["bound_by"])

    world_fo = core.RandomForestRegressor(device=dev).load_arrays(
        a.feat, a.thr, a.leaf).device_arrays()
    for m in (16, 40):
        s, r, f = 1000, 4, X_world.shape[1]
        x = X_world[rng.integers(0, len(X_world), s * m * r)]
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        pred = ref.rfr_forest_ref(xt, *world_fo).cpu().numpy()
        for log_target in (False, True):
            p = np.exp(pred) if log_target else pred
            bounds = (p * rng.uniform(0.97, 1.03, p.shape)).astype(
                np.float32).reshape(s, m, r)
            for i in range(s):
                bounds[i, :, int(rng.integers(1, r + 1)):] = np.inf
                bounds[i, int(rng.integers(0, m + 1)):, :] = -np.inf
            xs = xt.reshape(s, m, r, f)
            bt = torch.from_numpy(bounds).to(dev)
            got = rfr_capacity_sweep(xs, bt, *world_fo,
                                     log_target=log_target)
            plain = ref.rfr_capacity_sweep_ref(xs, bt, *world_fo,
                                               log_target=log_target)
            torch.cuda.synchronize()
            same = torch.equal(got, plain)
            print(f"phase1 rfr_capacity_sweep world S={s} M={m} R={r} "
                  f"log_target={log_target}: equal={same} "
                  f"mean_capacity={float(got.float().mean()):.3f}")
            check(same, f"rfr_capacity_sweep M={m} log={log_target}")
            if m == 16 and log_target:
                k = time_ms(lambda: rfr_capacity_sweep(
                    xs, bt, *world_fo, log_target=True))
                kd = time_ms(lambda: rfr_capacity_sweep(
                    xs, bt, *world_fo, log_target=True), queued=True)
                pl = time_ms(lambda: ref.rfr_capacity_sweep_ref(
                    xs, bt, *world_fo, log_target=True))
                rows, _ = sweep_rows(bt, plain)
                b, by = sweep_bound(tuple(xs.shape), world_fo[0], True, rows)
                timings[f"rfr_capacity_sweep world S={s} M={m} R={r}"] = (
                    k, kd, pl, b, by)
    phase1_padded_sweeps(rng, dev)
    for key, (k, kd, p, b, by) in timings.items():
        print(f"phase1 time {key}: kernel {k:.4f} ms (device {kd:.4f} ms), "
              f"plain {p:.4f} ms, bound {b:.5f} ms ({by})")


def phase1_padded_sweeps(rng, dev):
    """rfr_capacity_sweep with the device drain's padding, exactly equal
    to its plain version: -inf rows past each scenario's m_max, +inf rows
    past its R, a failure at m = 0 in every fifth scenario; T = 5 (the
    lanes' partial sums all 0), 24, 33 (a tail of one tree) and 130
    (numpy's pairwise split above 128 trees) at depth 6, and T = 64 at
    depth 10 (the forest read from device memory).  Then m_max on a pass
    boundary: a block takes 64 rows a pass, 8 values of m at R = 8, so
    m_max = 8 or 16 makes whole passes of -inf rows, which fail without a
    descent while the pass is under way; 4,096 scenarios, 20 launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rfr_inference import rfr_capacity_sweep
    s, r, f = 300, 8, 31
    for t, depth in ((5, 6), (24, 6), (33, 6), (130, 6), (64, 10)):
        forest = [torch.from_numpy(a).to(dev)
                  for a in _random_forest(rng, t, depth, f)]
        for m in (1, 24, 40):
            x = rng.standard_normal((s, m, r, f)).astype(np.float32)
            bounds = rng.uniform(-0.4, 0.8, (s, m, r)).astype(np.float32)
            for i in range(s):
                bounds[i, :, int(rng.integers(1, r + 1)):] = np.inf
                bounds[i, int(rng.integers(0, m + 1)):, :] = -np.inf
                if i % 5 == 0:
                    bounds[i, 0, 0] = -5.0
            args = (torch.from_numpy(x).to(dev),
                    torch.from_numpy(bounds).to(dev), *forest)
            for log_target in (False, True):
                got = rfr_capacity_sweep(*args, log_target=log_target)
                plain = ref.rfr_capacity_sweep_ref(*args,
                                                   log_target=log_target)
                torch.cuda.synchronize()
                same = torch.equal(got, plain)
                rows, padded = sweep_rows(args[1], plain)
                print(f"phase1 rfr_capacity_sweep padded T={t} D={depth} "
                      f"S={s} M={m} R={r} log_target={log_target}: "
                      f"equal={same}, rows needed {rows} of {padded}")
                check(same, f"rfr_capacity_sweep padded T={t} M={m} "
                      f"log={log_target}")
    s, m = 4096, 24
    forest = [torch.from_numpy(a).to(dev)
              for a in _random_forest(rng, 24, 8, f)]
    x = torch.from_numpy(rng.standard_normal((s, m, r, f)).astype(
        np.float32)).to(dev)
    bounds = rng.uniform(0.3, 1.5, (s, m, r)).astype(np.float32)
    bounds[0::2, 8:] = -np.inf
    bounds[1::2, 16:] = -np.inf
    early = np.arange(0, s, 7)
    bounds[early, rng.integers(0, 8, early.size),
           rng.integers(0, r, early.size)] = -1.0
    args = (x, torch.from_numpy(bounds).to(dev), *forest)
    plain = ref.rfr_capacity_sweep_ref(*args)
    same = sum(torch.equal(rfr_capacity_sweep(*args), plain)
               for _ in range(20))
    caps = torch.bincount(plain.long()).tolist()
    print(f"phase1 rfr_capacity_sweep m_max on a pass boundary S={s} M={m} "
          f"R={r} T=24 D=8: equal in {same} of 20 launches; capacities "
          f"{caps}")
    check(same == 20, "rfr_capacity_sweep with m_max on a pass boundary")


def _pattern_nodes(specs, n_nodes: int, seed: int):
    """Nodes drawn from a fixed pool of colocation patterns, as a fleet
    of a few dozen archetypes looks."""
    import numpy as np
    from repro_torch.core.cluster import Node
    from repro_torch.core.interference import NodeResources
    rng = np.random.default_rng(seed)
    names = sorted(specs)
    pool = []
    for _ in range(N_PATTERNS):
        pat = {}
        for g in rng.choice(names, size=int(rng.integers(1, 4)),
                            replace=False):
            pat[g] = (int(rng.integers(1, 6)), int(rng.integers(0, 3)))
        pool.append(pat)
    nodes = []
    for _ in range(n_nodes):
        node = Node(NodeResources())
        for g, (ns, nc) in pool[rng.integers(len(pool))].items():
            node.state(g).n_sat = ns
            node.state(g).n_cached = nc
        nodes.append(node)
    return nodes


def _drains(world, nodes, m_max: int):
    """The nodes' capacity tables from the numpy host drain and from the
    device drain on the CUDA sweep kernel (each node's table as sorted
    (function, capacity) pairs, the nodes in order); returns (host
    tables, device tables, host service, device service, recorder of the
    sweep's inputs, host seconds, device seconds)."""
    import torch
    import repro_torch.core as core

    def tables():
        out = [sorted((fn, e.capacity) for fn, e in n.table.items())
               for n in nodes]
        for n in nodes:
            n.table.clear()
        return out

    args = (world.predictor, world.store, world.qos, world.scenario.specs)
    host = core.PredictionService(*args, core.EngineConfig(m_max=m_max),
                                  engine="numpy")
    t0 = time.perf_counter()
    host.update_nodes(nodes)
    host_s = time.perf_counter() - t0
    want = tables()
    dev = core.PredictionService(
        *args, core.EngineConfig(m_max=m_max, drain="device"),
        engine="cuda")
    rec = Recorder()
    try:
        t0 = time.perf_counter()
        dev.update_nodes(nodes)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    finally:
        rec.close()
    return want, tables(), host, dev, rec, host_s, dev_s


def phase2_drain(world):
    nodes = _pattern_nodes(world.scenario.specs, DRAIN_NODES, DRAIN_NODES)
    want, got, host, dev, rec, host_s, dev_s = _drains(world, nodes,
                                                       DRAIN_M_MAX)
    st = dev.stats
    print(f"phase2 drain {DRAIN_NODES} nodes m_max={DRAIN_M_MAX}: "
          f"S={st.unique_solves} rows={st.rows_built} "
          f"device {dev_s * 1e3:.2f} ms, numpy host {host_s * 1e3:.2f} ms "
          f"(host rows {host.stats.rows_built}), tables_equal={got == want}")
    check(got == want, "phase 2: device-drain tables differ from numpy")
    check(rec.sweep is not None, "phase 2 never reached the sweep kernel")
    _err, k, kd, p, b, by, rows, padded = hold_sweep(*rec.sweep)
    print(f"phase2 time rfr_capacity_sweep {tuple(rec.sweep[0].shape)}: "
          f"kernel {k:.4f} ms (device {kd:.4f} ms), "
          f"plain {p:.4f} ms, bound {b:.6f} ms ({by}) over the {rows} rows "
          f"the inputs need of {padded} padded")
    phase2_other_worlds()


def phase2_other_worlds():
    """Does the sweep's expf (the predictor's log target) ever flip a
    capacity where numpy's float32 exp decides it?  Device-drain tables
    against the numpy host drain on worlds of three more traces, three
    seeds each (SETTLE_NODES pattern nodes, m_max 16, each world's own
    forest); a table that differs is printed node by node with both
    capacities, and fails the phase."""
    import repro_torch.core as core
    for trace in SETTLE_TRACES:
        for seed in SETTLE_SEEDS:
            scn = core.make_scenario(trace, n_functions=24, duration_s=180,
                                     target_nodes=256, seed=seed)
            world = core.scenario_world(scn, engine="numpy")
            nodes = _pattern_nodes(world.scenario.specs, SETTLE_NODES, seed)
            want, got, _h, dev, rec, _hs, dev_s = _drains(world, nodes,
                                                          DRAIN_M_MAX)
            diff = [(i, w, g) for i, (w, g) in enumerate(zip(want, got))
                    if w != g]
            print(f"phase2 drain {trace} seed {seed}: {SETTLE_NODES} nodes, "
                  f"S={dev.stats.unique_solves} rows={dev.stats.rows_built} "
                  f"sweep launches {len(rec.sweep_calls)}, device "
                  f"{dev_s * 1e3:.2f} ms, tables_equal={not diff}")
            for i, w, g in diff[:10]:
                print(f"phase2   node {i}: numpy {w}, device {g}")
            check(rec.sweep is not None,
                  f"phase 2 {trace} seed {seed} never reached the sweep")
            check(not diff, f"phase 2 {trace} seed {seed}: {len(diff)} "
                  "device-drain tables differ from numpy")


def _main_path_sim(label: str, engine: str, drain: str,
                   duration_s: int = SCENARIO["duration_s"]):
    """A fresh world (the ground truth's noise RNG is stateful) and the
    main path's Simulation on it, `duration_s` simulated seconds long;
    returns (sim, world build seconds)."""
    import repro_torch.core as core
    scn = core.make_scenario("burst-storm",
                             **dict(SCENARIO, duration_s=duration_s))
    t0 = time.perf_counter()
    world = core.scenario_world(scn, engine=engine)
    build_s = time.perf_counter() - t0
    name = "jiagu" if drain == "host" else "jiagu-device-drain"
    sim = core.scenario_simulation(scn, name, world=world)
    check(sim.scheduler.prediction_service.cfg.drain == drain,
          f"run {label}: service drain is not {drain}")
    return sim, build_s


def _run(label: str, engine: str, drain: str):
    import torch
    from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                                   rfr_forest_apply,
                                                   reset_launches)
    sim, build_s = _main_path_sim(label, engine, drain)
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"rfr_forest_apply": rfr_forest_apply.launches,
                "rfr_capacity_sweep": rfr_capacity_sweep.launches}
    out = outcome(res, sim)
    print(f"phase3 run ({label}) engine={engine} drain={drain}: world "
          f"{build_s:.2f} s, run {run_s:.2f} s, density "
          f"{out['density']!r}, qos_violation_rate "
          f"{out['qos_violation_rate']!r}, nodes_peak {out['nodes_peak']}, "
          f"sched {out['sched']}, scaling {out['scaling']}, inference "
          f"calls {res.inference_calls} rows {res.inference_rows}, "
          f"mean_inference_ms {res.mean_inference_ms:.4f}, "
          f"launches {launches}")
    return out, launches


def phase3_main_path():
    import repro_torch.core as core
    core.register_scheduler("jiagu-device-drain", device_drain_jiagu,
                            needs_predictor=True, dual_staged_default=True,
                            overwrite=True)
    oracle, _ = _run("a", "numpy", "host")
    rec = Recorder()
    try:
        host_cuda, l_b = _run("b", "cuda", "host")
        dev_cuda, l_c = _run("c", "cuda", "device")
    finally:
        rec.close()
    for label, got in (("b", host_cuda), ("c", dev_cuda)):
        diff = [k for k in oracle if got[k] != oracle[k]]
        n_tables = sum(x != y for x, y in zip(got["tables"],
                                               oracle["tables"]))
        print(f"phase3 run ({label}) vs oracle (a): differing fields "
              f"{diff or 'none'}; nodes with differing tables {n_tables} "
              f"of {len(oracle['tables'])}")
        check(not diff, f"run ({label}) differs from the oracle in {diff}")
    check(l_b["rfr_forest_apply"] > 0, "run (b) never launched the forest "
          "kernel")
    check(l_c["rfr_capacity_sweep"] > 0, "run (c) never launched the sweep "
          "kernel")
    fc = sorted(rec.forest_calls)
    print(f"phase3 shapes: forest calls {len(fc)}, N median "
          f"{fc[len(fc) // 2] if fc else 0} max {fc[-1] if fc else 0}")
    print_sweep_shapes(rec.sweep_calls)
    return rec, l_b, l_c


def sweep_rank(shape) -> tuple:
    """Order of sweep call shapes: by padded rows S*M*R, then the shape."""
    return (shape[0] * shape[1] * shape[2], shape)


def print_sweep_shapes(calls):
    """The distribution of the sweep calls' (S, M, R, F) shapes."""
    from collections import Counter
    if not calls:
        print("phase3 sweep shapes: no calls")
        return
    n = len(calls)
    ranked = sorted(calls, key=sweep_rank)

    def pct(vals, q):
        vals = sorted(vals)
        return vals[min(n - 1, int(q * n))]

    def counts(axis):
        return dict(sorted(Counter(c[axis] for c in calls).items()))

    s_vals = [c[0] for c in calls]
    print(f"phase3 sweep shapes: {n} calls, {len(set(calls))} distinct; "
          f"median {ranked[n // 2]}, largest {ranked[-1]}; S p10 "
          f"{pct(s_vals, 0.1)} p50 {pct(s_vals, 0.5)} p90 {pct(s_vals, 0.9)} "
          f"max {max(s_vals)}; M {counts(1)}; R {counts(2)}; most common "
          f"{Counter(calls).most_common(5)}")


def device_share(label: str, engine: str, drain: str):
    """The main path once more under torch.profiler, device activity
    only, PROFILED_S simulated seconds of it: the device's busy time
    (kernels and copies, from CUPTI) over the run's wall time, and the
    largest device entries.  A measurement only; prints "not measured"
    when the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim, _ = _main_path_sim(label, engine, drain, PROFILED_S)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in rows) / 1e6
    if busy_s <= 0:
        print(f"phase3 device ({label}): busy share not measured (the "
              "profiler recorded no device time)")
        return
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:4]
    print(f"phase3 device ({label}) engine={engine} drain={drain}, "
          f"profiled run ({PROFILED_S} simulated s) {wall:.2f} s: device "
          f"busy {busy_s:.4f} s, idle "
          f"share {1 - busy_s / wall:.4f}; largest: " + "; ".join(
              f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f}"
              f" ms" for e in top))
    for kernel in ("forest_apply_kernel", "capacity_sweep_kernel"):
        mine = [e for e in rows if kernel in e.key]
        if mine:
            print(f"phase3 device ({label}): {kernel} x"
                  f"{sum(e.count for e in mine)}, device "
                  f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} "
                  "ms in all")


def main_path_kernels(rec, l_b, l_c):
    """Both kernels against their plain versions on the largest inputs
    the main path gave them, timed; the kernels JSON entries.  The
    forest kernel is also timed at the median call's row count, the
    first forest kernel beside it at both."""
    check(rec.forest is not None and rec.sweep is not None,
          "main path left no kernel inputs on the card")
    x, feat, thr, leaf = rec.forest
    big = hold_forest(x, feat, thr, leaf)
    n_med = sorted(rec.forest_calls)[len(rec.forest_calls) // 2]
    med_f = hold_forest(x[:n_med], feat, thr, leaf)
    xs = rec.sweep[0]
    (err_s, ms_s, dms_s, pms_s, b_s, by_s, rows_s,
     pad_s) = hold_sweep(*rec.sweep)
    med = sorted(rec.sweep_calls, key=sweep_rank)[len(rec.sweep_calls) // 2]
    _e, ms_sm, dms_sm, pms_sm, b_sm, _by, rows_sm, pad_sm = hold_sweep(
        *rec.sweep_by_shape[med])
    for label, m, n in (("largest", big, x.shape[0]), ("median", med_f,
                                                          n_med)):
        print(f"main-path shapes: rfr_forest_apply {label} call N={n} F="
              f"{x.shape[1]}: kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f} ms), first kernel {m['v1_ms']:.4f} ms "
              f"(device {m['v1_device_ms']:.4f} ms), plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms")
    print(f"main-path shapes: rfr_capacity_sweep largest {tuple(xs.shape)}: "
          f"kernel {ms_s:.4f} ms (device {dms_s:.4f} ms), plain "
          f"{pms_s:.4f} ms, bound {b_s:.6f} ms ({by_s}; rows needed "
          f"{rows_s} of {pad_s} padded); median call {med}: kernel "
          f"{ms_sm:.4f} ms (device {dms_sm:.4f} ms), plain {pms_sm:.4f} ms, "
          f"bound {b_sm:.6f} ms (rows needed {rows_sm} of {pad_sm} padded)")
    return [
        {"name": "rfr_forest_apply", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_forest_apply"],
         "launches": l_b["rfr_forest_apply"],
         "max_abs_err": big["max_abs_err"], "ms": big["ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None,
         "shape": list(x.shape), "device_ms": big["device_ms"],
         "v1_ms": big["v1_ms"], "v1_device_ms": big["v1_device_ms"],
         "median_shape": [n_med, x.shape[1]], "median_ms": med_f["ms"],
         "median_device_ms": med_f["device_ms"],
         "median_v1_ms": med_f["v1_ms"],
         "median_v1_device_ms": med_f["v1_device_ms"],
         "median_bound_ms": med_f["bound_ms"]},
        {"name": "rfr_capacity_sweep", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["rfr_capacity_sweep"],
         "launches": l_c["rfr_capacity_sweep"], "max_abs_err": err_s,
         "ms": ms_s, "plain_ms": pms_s, "bound_ms": b_s, "bound_by": by_s,
         "library_ms": None, "shape": list(xs.shape), "device_ms": dms_s,
         "median_shape": list(med), "median_ms": ms_sm,
         "median_device_ms": dms_sm},
    ]


# ---------------------------------------------------------------------------
# phases 4 and 5: the LM kernels and serving recurrentgemma-2b
# ---------------------------------------------------------------------------


def matmul_peak(dtype) -> float:
    """The card's dense tensor-core rate for products of `dtype` inputs:
    bf16, or TF32 for f32 (the rate an f32-accurate 3xTF32 kernel draws
    on; the CUDA cores' 67 TFLOP/s is printed beside as the old bound)."""
    import torch
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32_OPS_PER_S


def flash_bound(bh: int, bh_kv: int, s: int, d: int, dtype, pairs: int,
                peak=None, dv=None):
    """q, k, v read once and o written once; 2*(D + Dv) operations (a
    multiply-add a column for q.k and for p.v; 4*D where Dv = D) per
    query-key pair the mask keeps, at the tensor-core rate for the inputs'
    type (or `peak`).  q and k have D columns, v and o Dv (D when None)."""
    import torch
    dv = d if dv is None else dv
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((bh + bh_kv) * d + (bh + bh_kv) * dv) * s * esize
    return bound(nbytes, 2 * (d + dv) * bh * pairs,
                 peak or matmul_peak(dtype))


def tf32_flash(q, k, v, kw):
    """The 3xTF32 kernel of csrc/flash_attention_tf32.cu called directly
    (f32, D = Dv in 64, 96, 128, 256 or MLA's (192, 128)); not counted in
    the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = q.new_empty((bh, s, dv))
    lib = _build.load("flash_attention_tf32")
    mask = (int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
            int(kw.get("window", 0)))
    splits = lib.flash_attention_tf32_splits(bh, s, d, dv, *mask)
    part = torch.empty(splits * bh * s * (dv + 2), device=q.device)
    err = lib.flash_attention_tf32_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part.data_ptr(), None, bh, s, d, dv, bh // k.shape[0], *mask,
        float(kw.get("softcap", 0.0)), splits,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention (tf32, direct)")
    return out


def simt_flash(q, k, v, kw):
    """The CUDA-core kernel of csrc/flash_attention.cu called directly, so
    that it can be held and timed at shapes where the wrapper takes a
    tensor-core path; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = q.new_empty((bh, s, dv))
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        dv, bh // k.shape[0], int(q.dtype == torch.bfloat16),
        int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
        int(kw.get("window", 0)), float(kw.get("softcap", 0.0)),
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention (simt, direct)")
    return out


def _flex(s: int, kw, device):
    """flash_attention's function for flex_attention: the compiled call,
    the block mask of `kw`'s mask at S = `s` and the tanh softcap as its
    score_mod (query head h reads kv head h // G through enable_gqa, as
    the kernel does).  Inductor's and triton's caches under the
    checkout's build/."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    cap = float(kw["softcap"])
    causal, kind = kw.get("causal", True), kw.get("kind", "global")
    window = int(kw.get("window", 0))

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki if causal else qi == qi
        if kind == "local":
            keep = keep & (qi - ki < window)
        elif kind == "chunked":
            keep = keep & (qi // window == ki // window)
        return keep

    def softcap(score, b, h, qi, ki):
        return torch.tanh(score / cap) * cap

    block = create_block_mask(mask_mod, None, None, s, s, device=device)
    flex = torch.compile(flex_attention, dynamic=False)
    return flex, block, softcap


def flex_library(q, k, v, kw):
    """flash_attention's function as one compiled flex_attention call
    (``_flex``).  The library yardstick where a softcap rules sdpa out.
    Builds the block mask and compiles here, outside any timed call;
    returns (the call, its output, the seconds that took)."""
    import torch
    t0 = time.perf_counter()
    flex, block, softcap = _flex(q.shape[1], kw, q.device)
    q4, k4, v4 = q[None], k[None], v[None]

    def library():
        return flex(q4, k4, v4, score_mod=softcap, block_mask=block,
                    enable_gqa=True)

    got = library()[0]
    torch.cuda.synchronize()
    return library, got, time.perf_counter() - t0


def flex_library_bwd(q, k, v, do, kw):
    """``flex_library``'s call with its gradient: (its forward, its
    forward and backward through ``torch.autograd.grad`` by `do`, the
    seconds the block mask and both compiles took), each compiled here,
    outside any timed call."""
    import torch
    t0 = time.perf_counter()
    flex, block, softcap = _flex(q.shape[1], kw, q.device)
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))

    def library_fwd():
        return flex(q4, k4, v4, score_mod=softcap, block_mask=block,
                    enable_gqa=True)

    def library_both():
        return torch.autograd.grad(library_fwd(), (q4, k4, v4), do[None])

    library_both()
    library_fwd()
    torch.cuda.synchronize()
    return library_fwd, library_both, time.perf_counter() - t0


def hold_flash(q, k, v, kw, with_library: bool):
    """flash_attention on q, k (BH, S, D) and v (BH, S, Dv) tensors
    against its plain version (k and v repeated, materialised softmax),
    both timed; the library yardstick is scaled_dot_product_attention
    with the same boolean mask (which takes Dv other than D, and groups
    of query heads over fewer kv heads through `enable_gqa`), or with a
    softcap, which sdpa does not take, one compiled flex_attention call
    (``flex_library``), held against the plain version as the kernel is.
    The wrapper must launch the kernel that ``path`` names; where that is
    a tensor-core kernel, the CUDA-core kernel is held and timed beside
    it.  f32 with a softcap on the 3xTF32 kernel is held against the
    function evaluated in float64 (``f64_flash``), within the same f32
    tolerance: at softcapped scores the plain f32 version's own rounding
    is of the tolerance's size (up to 0.86 of it from float64), and the
    kernel forms its scores in double; the distance from the plain f32
    version is returned beside ("plain_err", "plain_worst").  Returns a
    dict of the measurements."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, path
    bh, s, d = q.shape
    dv = v.shape[-1]
    group = bh // k.shape[0]
    dt = str(q.dtype).split(".")[-1]
    first, second = ATTN_TOL[dt]

    def plain(values=v):
        return ref.flash_attention_ref(q, k.repeat_interleave(group, 0),
                                       values.repeat_interleave(group, 0),
                                       **kw)

    def held(got, want, what):
        wide = torch.float64 if want.dtype == torch.float64 else torch.float32
        want = want.to(wide)
        diff = (got.to(wide) - want).abs()
        err = float(diff.max())
        if dt == "bfloat16":
            allowed = first * want.abs() + second * plain(v.abs()).float()
        else:
            allowed = first + second * want.abs()
        worst = float((diff / allowed).max())
        check(worst <= 1.0, f"flash_attention ({what}) S={s} D={d} {dt} "
              f"{kw}: max_abs_err {err}, the worst element at {worst:.3g} "
              f"of its allowance")
        return err, worst

    n0 = dict(flash_attention.launches_by_path)
    got = flash_attention(q, k, v, **kw)
    ran = [p for p, n in flash_attention.launches_by_path.items()
           if n != n0[p]]
    want = plain()
    torch.cuda.synchronize()
    want_path = path(q.dtype, d, kw.get("softcap", 0.0), dv)
    check(ran == [want_path], f"flash_attention S={s} D={d} Dv={dv} {dt}: "
          f"ran {ran}, path says {want_path}")
    out = {}
    if dt == "float32" and kw.get("softcap") and ran[0] == "tf32":
        # the distance from the plain f32 version, printed beside
        out["witness"] = "float64"
        out["plain_err"] = float((got - want).abs().max())
        out["plain_worst"] = float(((got - want).abs()
                                    / (first + second * want.abs())).max())
        want = f64_flash(q, k, v, kw)
    err, worst = held(got, want, ran[0])
    mask = ref.attention_mask(s, kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    pairs = int(mask.sum())
    out.update({"max_abs_err": err, "worst": worst, "pairs": pairs,
                "path": ran[0]})
    if ran[0] in ("tf32", "wgmma"):
        out["kv_shares"] = kv_shares(ran[0], bh, s, d, dv, kw)
    if with_library:
        def kernel():
            return flash_attention(q, k, v, **kw)

        if kw.get("softcap"):
            library, got_lib, out["library_setup_s"] = flex_library(
                q, k, v, kw)
            out["library"] = "flex_attention"
            out["library_err"], out["library_worst"] = held(
                got_lib, want, "flex_attention")
        else:
            q4 = q.view(1, bh, s, d)
            gqa = 1 < group < bh
            if gqa:
                # query head h reads kv head h // G, as the kernel does
                k4, v4 = k.view(1, -1, s, d), v.view(1, -1, s, dv)
            else:
                # one kv head (MQA), or one for each query head
                k4 = k.view(1, -1, s, d).expand(1, bh, s, d)
                v4 = v.view(1, -1, s, dv).expand(1, bh, s, dv)

            def library():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=gqa)

            out["library"] = "sdpa"
        # the kernel and the library call are compared: timed in turn
        out["ms"], out["library_ms"] = time_pair_ms(kernel, library)
        out["device_ms"], out["library_device_ms"] = time_pair_ms(
            kernel, library, queued=True)
        if ran[0] != "simt":
            out["simt_err"], out["simt_worst"] = held(
                simt_flash(q, k, v, kw), want, "simt")
            out["simt_ms"] = time_ms(lambda: simt_flash(q, k, v, kw))
            out["simt_device_ms"] = time_ms(lambda: simt_flash(q, k, v, kw),
                                            queued=True)
        out["plain_ms"] = time_ms(plain)
        out["bound_ms"], out["bound_by"] = flash_bound(
            bh, k.shape[0], s, d, q.dtype, pairs, dv=dv)
        if q.dtype == torch.float32:
            out["cuda_core_bound_ms"], _ = flash_bound(
                bh, k.shape[0], s, d, q.dtype, pairs, F32_OPS_PER_S, dv=dv)
    return out


def kv_shares(kernel: str, bh: int, s: int, d: int, dv: int, kw) -> int:
    """The kv shares the tensor-core forward `kernel` ("wgmma" or "tf32")
    cuts each q tile's kv range into at this shape (1: no split)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    name = f"flash_attention_{kernel}"
    return getattr(_build.load(name), name + "_splits")(
        bh, s, d, dv, int(kw.get("causal", True)),
        KINDS[kw.get("kind", "global")], int(kw.get("window", 0)))


def f64_flash(q, k, v, kw):
    """flash_attention's function evaluated in float64 on the same q, k,
    v (k and v repeated to q's rows): the witness of f32 attention with a
    softcap, whose plain f32 version rounds at the tolerance's size."""
    import torch
    from repro_torch.kernels import ref
    group = q.shape[0] // k.shape[0]
    kr, vr = (a.double().repeat_interleave(group, 0) for a in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.double(), kr) / q.shape[-1] ** 0.5
    if kw.get("softcap"):
        s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
    mask = ref.attention_mask(q.shape[1], kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    s = torch.where(mask[None], s, torch.full_like(s, ref.NEG_INF))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), vr)


def f64_shares(q, k, v, kw) -> str:
    """f32 attention's worst element against the same function in
    float64, as a share of the f32 tolerance (1e-5 absolute plus 1e-5
    relative), for the 3xTF32 kernel (called directly where the wrapper
    would not take it), the CUDA-core kernel and the plain version."""
    from repro_torch.kernels import ref
    group = q.shape[0] // k.shape[0]
    want = f64_flash(q, k, v, kw)

    def share(got):
        return float(((got.double() - want).abs()
                      / (1e-5 + 1e-5 * want.abs())).max())

    plain = share(ref.flash_attention_ref(
        q, k.repeat_interleave(group, 0), v.repeat_interleave(group, 0),
        **kw))
    return (f"3xTF32 kernel {share(tf32_flash(q, k, v, kw)):.3g}, CUDA-core "
            f"kernel {share(simt_flash(q, k, v, kw)):.3g}, plain "
            f"{plain:.3g} of the tolerance")


def first_scan(a, b, h0):
    """The first kernel of csrc/rglru_scan.cu, one thread a channel,
    called directly so that it can be held and timed beside the
    wrapper's; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    bsz, s, w = a.shape
    out = torch.empty_like(a)
    lib = _build.load("rglru_scan")
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), bsz, s, w, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "rglru_scan (first kernel)")
    return out


def hold_scan(a, b, h0):
    """rglru_scan against its plain version and the first kernel, each
    exactly; the wrapper must take the kernel ``path`` names, and on the
    TMA path its device time must be no larger than the first kernel's.
    All timed; returns a dict of the measurements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import path, rglru_scan
    what = f"rglru_scan {tuple(a.shape)} h0={h0 is not None}"
    n0 = dict(rglru_scan.launches_by_path)
    got = rglru_scan(a, b, h0)
    ran = [k for k, n in rglru_scan.launches_by_path.items() if n != n0[k]]
    want = ref.rglru_scan_ref(a, b, h0)
    first = first_scan(a, b, h0)
    torch.cuda.synchronize()
    check(ran == [path(*a.shape)], f"{what}: ran {ran}, path says "
          f"{path(*a.shape)}")
    err = float((got - want).abs().max())
    out = {"path": ran[0], "max_abs_err": err,
           "simt_err": float((first - want).abs().max())}
    check(err == 0 and out["simt_err"] == 0,
          f"{what}: max_abs_err {err}, first kernel {out['simt_err']}")
    n = a.numel()
    nbytes = 3 * n * 4 + (0 if h0 is None else h0.numel() * 4)
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * n)
    out["ms"] = time_ms(lambda: rglru_scan(a, b, h0))
    out["device_ms"] = time_ms(lambda: rglru_scan(a, b, h0), queued=True)
    out["simt_ms"] = time_ms(lambda: first_scan(a, b, h0))
    out["simt_device_ms"] = time_ms(lambda: first_scan(a, b, h0),
                                    queued=True)
    if ran[0] == "tma":
        check(out["device_ms"] <= out["simt_device_ms"],
              f"{what}: device {out['device_ms']:.4f} ms, slower than the "
              f"first kernel's {out['simt_device_ms']:.4f} ms")
    out["plain_ms"] = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), reps=5)
    out["library_ms"] = None
    return out


def ssd_bound(bsz: int, heads: int, groups: int, s: int, p: int, n: int,
              dtype, with_h0: bool, peak=None):
    """x and y, dA and dt, the grouped B and C read or written once, h0
    read and the final state written in f32; operations at the kernels'
    chunk of 64: 2N (C B^T) and 2P (M x) per row pair the causal mask
    keeps within a chunk, 2NP (C h^T) and 2NP (the state update) per
    row, at the tensor-core rate for the inputs' type (or `peak`)."""
    import torch
    from repro_torch.kernels.ssd_scan import CHUNK
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (esize * (2 * bsz * heads * s * p + 2 * bsz * groups * s * n)
              + 4 * 2 * bsz * heads * s
              + 4 * bsz * heads * p * n * (2 if with_h0 else 1))
    pairs = sum(c * (c + 1) // 2 for c in
                (min(CHUNK, s - c0) for c0 in range(0, s, CHUNK)))
    ops = bsz * heads * (2 * pairs * (n + p) + 4 * s * n * p)
    return bound(nbytes, ops, peak or matmul_peak(dtype))


def simt_ssd(x, dA, dt, Bm, Cm, h0):
    """The CUDA-core kernel of csrc/ssd_scan.cu called directly, so that it
    can be held and timed at shapes where the wrapper takes the
    tensor-core path; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    bsz, heads, s, p = x.shape
    groups, n = Bm.shape[1], Bm.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((bsz, heads, p, n), dtype=torch.float32, device=x.device)
    err = _build.load("ssd_scan").ssd_scan_fwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), bsz, heads, groups, s, p, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssd_scan (simt, direct)")
    return y, h


def hold_ssd(x, dA, dt, Bm, Cm, h0, timed: bool):
    """ssd_scan against its plain version at the kernels' chunk; the
    wrapper must launch the kernel that ``path`` names, and where that is
    the tensor-core kernel the CUDA-core kernel is held beside it.  With
    `timed`, each timed and the bound computed.  Returns a dict of the
    measurements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import CHUNK, path, ssd_scan

    def plain():
        return ref.ssd_scan_ref(x, dA, dt, Bm, Cm, h0, chunk=CHUNK)

    bsz, heads, s, p = x.shape
    dt_name = str(x.dtype).split(".")[-1]
    what = f"ssd_scan S={s} {dt_name} h0={h0 is not None}"
    n0 = dict(ssd_scan.launches_by_path)
    y, h = ssd_scan(x, dA, dt, Bm, Cm, h0)
    ran = [k for k, n in ssd_scan.launches_by_path.items() if n != n0[k]]
    yp, hp = plain()
    torch.cuda.synchronize()
    want_path = path(x.dtype, p, Bm.shape[3])
    check(ran == [want_path], f"{what}: ran {ran}, path says {want_path}")
    tol = SSD_TOL[dt_name]
    y_scale = float(yp.float().abs().max())

    def held(y, h, kernel):
        err = float((y.float() - yp.float()).abs().max())
        h_err = float((h - hp).norm() / hp.norm())
        check(bool(torch.isfinite(y.float()).all()),
              f"{what} ({kernel}): y not finite")
        check(err <= tol * y_scale, f"{what} ({kernel}): max_abs_err {err} "
              f"of {y_scale}")
        check(h_err <= tol, f"{what} ({kernel}): state differs by {h_err} "
              "in norm")
        return err, h_err

    err, h_err = held(y, h, ran[0])
    out = {"max_abs_err": err, "y_scale": y_scale, "h_err": h_err,
           "path": ran[0]}
    if ran[0] != "simt":
        out["simt_err"], out["simt_h_err"] = held(
            *simt_ssd(x, dA, dt, Bm, Cm, h0), "simt")
    if timed:
        out["ms"] = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm, h0))
        out["device_ms"] = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm, h0),
                                   queued=True)
        if ran[0] != "simt":
            out["simt_ms"] = time_ms(lambda: simt_ssd(x, dA, dt, Bm, Cm, h0))
            out["simt_device_ms"] = time_ms(
                lambda: simt_ssd(x, dA, dt, Bm, Cm, h0), queued=True)
        out["plain_ms"] = time_ms(plain)
        out["library_ms"] = None
        shape = (bsz, heads, Bm.shape[1], s, p, Bm.shape[3], x.dtype,
                 h0 is not None)
        out["bound_ms"], out["bound_by"] = ssd_bound(*shape)
        if x.dtype == torch.float32:
            out["cuda_core_bound_ms"], _ = ssd_bound(*shape, F32_OPS_PER_S)
    return out


def ssd_layout_cost(x, dA, dt, Bm, Cm, A):
    """What the model's layout costs around the scan: ``ops.ssd_op`` on
    (B, S, H, .) tensors (its transposes to the kernel's layout and dA =
    dt A, then the kernel) against the kernel alone on tensors already
    in its layout; printed."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    xm, dtm = x.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous()
    Bmm, Cmm = Bm.transpose(1, 2).contiguous(), Cm.transpose(1, 2).contiguous()
    op = time_ms(lambda: ops.ssd_op(xm, dtm, A, Bmm, Cmm), queued=True)
    alone = time_ms(lambda: ssd_scan(x, dA, dt, Bm, Cm), queued=True)
    print(f"phase4 ssd_scan layout S={x.shape[2]} {str(x.dtype)[6:]}: "
          f"ops.ssd_op in the model's layout device {op:.4f} ms, the "
          f"kernel alone {alone:.4f} ms: the transposes and dt A cost "
          f"{op - alone:.4f} ms a layer")


def phase4_lm_kernels():
    """The LM kernels against their plain versions on the card: flash
    attention at the serving shapes (B = 1, 10 query heads, 1 kv head,
    D = 256, local window 2,048) and at small shapes for the other masks;
    the RG-LRU scan at the serving widths; the SSD scan at mamba2-2.7b's
    serving shapes.  Returns the measurements of the largest serving
    shapes, for the kernels line."""
    import inspect
    import torch
    from repro_torch.kernels.flash_attention import path
    from repro_torch.kernels.rglru_scan import path as scan_path
    from repro_torch.kernels.ssd_scan import path as ssd_path
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for name, fn in (("flash_attention", path), ("rglru_scan", scan_path),
                     ("ssd_scan", ssd_path)):
        print(f"phase4 {name} chooses its kernel by its arguments alone:\n"
              + "".join(f"phase4 | {line}" for line in
                        inspect.getsourcelines(fn)[0]).rstrip())
    serve = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in SERVE_PROMPTS:
            q, k, v = randn(10, s, 256, dtype=dtype), \
                randn(1, s, 256, dtype=dtype), randn(1, s, 256, dtype=dtype)
            kw = dict(causal=True, kind="local", window=2048)
            m = hold_flash(q, k, v, kw, with_library=True)
            dt = str(dtype).split(".")[-1]
            simt = (f", simt kernel {m['simt_ms']:.4f} ms (device "
                    f"{m['simt_device_ms']:.4f} ms, max_abs_err "
                    f"{m['simt_err']:.3g}, {m['simt_worst']:.3g} of the "
                    "allowance)" if "simt_ms" in m else "")
            old_bound = (f"; at the CUDA cores' 67 TFLOP/s "
                         f"{m['cuda_core_bound_ms']:.5f} ms"
                         if "cuda_core_bound_ms" in m else "")
            shares = (f" ({m['kv_shares']} kv shares)" if "kv_shares" in m
                      else "")
            print(f"phase4 flash_attention BH=10 G=10 S={s} D=256 local "
                  f"2048 {dt} path={m['path']}{shares}: max_abs_err "
                  f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the "
                  f"allowance), kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms){simt}, plain "
                  f"{m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} ms "
                  f"(device {m['library_device_ms']:.4f} ms), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}{old_bound}), "
                  f"pairs {m['pairs']}")
            # both tensor-core paths serve these shapes and must not lose
            # to the library call in either measure
            want = "wgmma" if dtype == torch.bfloat16 else "tf32"
            check(m["path"] == want
                  and m["ms"] <= m["library_ms"]
                  and m["device_ms"] <= m["library_device_ms"],
                  f"flash_attention S={s} {dt}: path {m['path']}, "
                  f"{m['ms']:.4f} ms (device {m['device_ms']:.4f} ms) "
                  f"against sdpa {m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f} ms)")
            if s == max(SERVE_PROMPTS):
                key = ("flash_attention" if dtype == torch.bfloat16
                       else "flash_attention f32")
                serve[key] = dict(m, shape=[10, s, 256])
    masks = (dict(causal=True, kind="global"),
             dict(causal=True, kind="chunked", window=128),
             dict(causal=True, kind="global", softcap=50.0),
             dict(causal=False, kind="global"),
             dict(causal=False, kind="local", window=96))
    small = [(torch.bfloat16, 64, kw) for kw in masks]
    small += [(torch.float32, 64, kw) for kw in masks]
    small += [(torch.bfloat16, 128, kw) for kw in masks]
    small += [(torch.bfloat16, 32, masks[0])]
    for dtype, d, kw in small:
        scale = 8.0 if kw.get("softcap") else 1.0
        q = randn(8, 333, d, dtype=dtype) * scale
        k = randn(4, 333, d, dtype=dtype) * scale
        v = randn(4, 333, d, dtype=dtype)
        m = hold_flash(q, k, v, kw, with_library=False)
        exact = (", from float64: " + f64_shares(q, k, v, kw)
                 if dtype == torch.float32 else "")
        witness = (f", held against float64 (from the plain f32 version "
                   f"{m['plain_err']:.3g})" if "witness" in m else "")
        print(f"phase4 flash_attention BH=8 G=2 S=333 D={d} {kw} "
              f"{str(dtype).split('.')[-1]} path={m['path']}: max_abs_err "
              f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the allowance)"
              f"{witness}{exact}")
    # f32 with a softcap (scores of magnitude 16 and 64) on the 3xTF32
    # kernel, held against float64 within the f32 tolerance (the plain
    # version's own rounding is of the tolerance's size); the CUDA-core
    # kernel's and the plain version's shares and the distance from the
    # plain version printed beside
    for d in TF32_SOFTCAP_DIMS:
        for cap, scale in ((20.0, 4.0), (50.0, 8.0)):
            kw = dict(causal=True, kind="global", softcap=cap)
            q, k = randn(8, 333, d) * scale, randn(4, 333, d) * scale
            v = randn(4, 333, d)
            m = hold_flash(q, k, v, kw, with_library=False)
            check(m["path"] == "tf32", f"flash_attention D={d} {kw} "
                  f"float32: path {m['path']}")
            print(f"phase4 flash_attention BH=8 G=2 S=333 D={d} {kw} "
                  f"float32 x{scale:g} path={m['path']}: held against "
                  f"float64, max_abs_err {m['max_abs_err']:.3g} "
                  f"({m['worst']:.3g} of the allowance); from the plain f32 "
                  f"version {m['plain_err']:.3g} ({m['plain_worst']:.3g}); "
                  f"from float64: {f64_shares(q, k, v, kw)}")
    serve.update(phase4_train_lm(randn))
    for (bsz, s, w), with_h0 in (((1, 3000, 2560), False),
                                 ((1, 3000, 2560), True),
                                 ((4, 1000, 2560), False)):
        a = torch.rand((bsz, s, w), generator=gen, device=dev) * 0.5 + 0.5
        b = randn(bsz, s, w)
        h0 = randn(bsz, w) if with_h0 else None
        m = hold_scan(a, b, h0)
        print(f"phase4 rglru_scan ({bsz}, {s}, {w}) h0={with_h0} "
              f"path={m['path']}: max_abs_err {m['max_abs_err']} (first "
              f"kernel {m['simt_err']}), kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f} ms), first kernel "
              f"{m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} ms, "
              f"{m['simt_device_ms'] / m['device_ms']:.2f}x the new), plain "
              f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} ms "
              f"({m['bound_by']})")
        check(m["path"] == "tma", f"rglru_scan ({bsz}, {s}, {w}): path "
              f"{m['path']}")
        if (bsz, s, with_h0) == (1, 3000, False):
            serve["rglru_scan"] = dict(m, shape=[bsz, s, w])
    heads, p, n = 80, 64, 128
    A = -torch.linspace(1.0, 16.0, heads, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        for s in SSM_PROMPTS:
            for with_h0 in (False, True):
                dt = torch.nn.functional.softplus(randn(1, heads, s) - 2.0)
                args = (randn(1, heads, s, p, dtype=dtype),
                        dt * A[None, :, None], dt,
                        randn(1, 1, s, n, dtype=dtype),
                        randn(1, 1, s, n, dtype=dtype),
                        randn(1, heads, p, n) if with_h0 else None)
                m = hold_ssd(*args, timed=not with_h0)
                dt_name = str(dtype).split(".")[-1]
                line = (f"phase4 ssd_scan B=1 H={heads} G=1 S={s} P={p} "
                        f"N={n} {dt_name} h0={with_h0} path={m['path']}: "
                        f"max_abs_err {m['max_abs_err']:.3g} of max |y| "
                        f"{m['y_scale']:.3g}, state err {m['h_err']:.3g} "
                        "in norm")
                if "simt_err" in m:
                    line += (f" (simt kernel: {m['simt_err']:.3g}, state "
                             f"{m['simt_h_err']:.3g})")
                if not with_h0:
                    line += (f", kernel {m['ms']:.4f} ms (device "
                             f"{m['device_ms']:.4f} ms)")
                    if "simt_ms" in m:
                        line += (f", simt kernel {m['simt_ms']:.4f} ms "
                                 f"(device {m['simt_device_ms']:.4f} ms, "
                                 f"{m['simt_device_ms'] / m['device_ms']:.2f}"
                                 "x the new)")
                    line += (f", plain {m['plain_ms']:.4f} ms, bound "
                             f"{m['bound_ms']:.5f} ms ({m['bound_by']}, "
                             f"{m['bound_ms'] / m['device_ms']:.3f} of the "
                             "kernel's device time")
                    if "cuda_core_bound_ms" in m:
                        line += (f"; at the CUDA cores' 67 TFLOP/s "
                                 f"{m['cuda_core_bound_ms']:.5f} ms")
                    line += ")"
                print(line)
                if "simt_device_ms" in m:
                    check(m["device_ms"] <= m["simt_device_ms"],
                          f"ssd_scan S={s} {dt_name}: the tensor-core "
                          f"kernel {m['device_ms']:.4f} ms, slower than the "
                          f"CUDA-core kernel {m['simt_device_ms']:.4f} ms")
                if (s, with_h0) == (max(SSM_PROMPTS), False):
                    key = ("ssd_scan" if dtype == torch.bfloat16
                           else "ssd_scan f32")
                    serve[key] = dict(m, shape=[1, heads, s, p, n])
                    ssd_layout_cost(*args[:5], A)
    serve.update(phase4_mla(randn))
    return serve


def phase4_train_lm(randn) -> dict:
    """flash_attention at the ~100M training example's shape
    (``launch/train_lm.py``: BH 64 over 32 kv rows, S 512, D 96, causal,
    local 512, softcap 50, f32) on the 3xTF32 kernel: held against float64
    and timed as ``hold_flash`` times, beside the CUDA-core kernel, one
    compiled flex_attention call with the tanh softcap (f32), the plain
    version and the bound."""
    bh, g, s, d = TRAIN_LM_ATTN
    q, k, v = randn(bh, s, d), randn(bh // g, s, d), randn(bh // g, s, d)
    m = hold_flash(q, k, v, TRAIN_LM_KW, with_library=True)
    check(m["path"] == "tf32", f"flash_attention at the training example's "
          f"shape: path {m['path']}")
    print(f"phase4 flash_attention train_lm BH={bh} G={g} S={s} D={d} "
          f"{TRAIN_LM_KW} float32 path={m['path']} ({m['kv_shares']} kv "
          f"shares): held against float64, max_abs_err "
          f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the allowance; "
          f"from the plain f32 version {m['plain_err']:.3g}), kernel "
          f"{m['ms']:.4f} ms (device {m['device_ms']:.4f} ms), CUDA-core "
          f"kernel {m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} "
          f"ms), flex_attention {m['library_ms']:.4f} ms (device "
          f"{m['library_device_ms']:.4f} ms, compiled in "
          f"{m['library_setup_s']:.1f} s), plain {m['plain_ms']:.4f} ms, "
          f"bound {m['bound_ms']:.5f} ms ({m['bound_by']}; at the CUDA "
          f"cores' 67 TFLOP/s {m['cuda_core_bound_ms']:.5f} ms), pairs "
          f"{m['pairs']} a head")
    return {"flash_attention train_lm": dict(m, shape=[bh, s, d])}


def phase4_mla(randn) -> dict:
    """flash_attention at deepseek-v2-236b's MLA prefill shape: 128 heads
    (BH 128, group 1), q and k of head dim 192, v of 128, causal global,
    S = 512, 1,000, 2,048, 3,000; bf16 on the wgmma kernel, f32 on the
    3xTF32 kernel, the CUDA-core kernel held and timed beside each.  Each
    held against its plain version within ATTN_TOL and timed beside it,
    sdpa with the same bool mask and the bound; the f32 kernels' errors
    against float64 printed at S = 512 and 3,000; at S = 3,000 the f32
    kernel's device time at most sdpa's.  Returns the S = 3,000
    measurements of both dtypes."""
    import torch
    bh, d, dv = MLA_HEADS, MLA_QK_DIM, MLA_V_DIM
    kw = dict(causal=True, kind="global")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        for s in SERVE_PROMPTS:
            q, k, v = (randn(bh, s, d, dtype=dtype),
                       randn(bh, s, d, dtype=dtype),
                       randn(bh, s, dv, dtype=dtype))
            m = hold_flash(q, k, v, kw, with_library=True)
            exact = (f64_shares(q, k, v, kw) if dtype == torch.float32
                     and s in (min(SERVE_PROMPTS), max(SERVE_PROMPTS))
                     else None)
            del q, k, v
            want = "wgmma" if dtype == torch.bfloat16 else "tf32"
            check(m["path"] == want, f"flash_attention MLA S={s} {dt}: "
                  f"path {m['path']}, expected {want}")
            simt = (f", simt kernel {m['simt_ms']:.4f} ms (device "
                    f"{m['simt_device_ms']:.4f} ms, "
                    f"{m['simt_device_ms'] / m['device_ms']:.2f}x the "
                    f"{m['path']} kernel's; max_abs_err {m['simt_err']:.3g}, "
                    f"{m['simt_worst']:.3g} of the allowance)"
                    if "simt_ms" in m else "")
            old_bound = (f"; at the CUDA cores' 67 TFLOP/s "
                         f"{m['cuda_core_bound_ms']:.5f} ms"
                         if "cuda_core_bound_ms" in m else "")
            print(f"phase4 flash_attention MLA BH={bh} G=1 S={s} D={d} "
                  f"Dv={dv} causal global {dt} path={m['path']}: "
                  f"max_abs_err {m['max_abs_err']:.3g} ({m['worst']:.3g} of "
                  f"the allowance), kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms){simt}, plain "
                  f"{m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} ms "
                  f"(device {m['library_device_ms']:.4f} ms), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}{old_bound}), "
                  f"pairs {m['pairs']}")
            if exact is not None:
                print(f"phase4 flash_attention MLA BH={bh} S={s} D={d} "
                      f"Dv={dv} float32, from float64: {exact}")
            if dtype == torch.float32 and s == max(SERVE_PROMPTS):
                check(m["device_ms"] <= m["library_device_ms"],
                      f"flash_attention MLA S={s} {dt}: device "
                      f"{m['device_ms']:.4f} ms against sdpa's "
                      f"{m['library_device_ms']:.4f} ms")
            if s == max(SERVE_PROMPTS):
                key = "flash_attention mla" + (
                    "" if dtype == torch.bfloat16 else " f32")
                out[key] = dict(m, shape=[bh, s, d, dv])
    return out


def lm_counts() -> dict:
    """The LM kernel wrappers' launch counts, each also by path
    ("flash_attention.wgmma", "rglru_scan.tma", "ssd_scan.simt", ...)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    counts = {"flash_attention": flash_attention.launches}
    for p, n in flash_attention.launches_by_path.items():
        counts[f"flash_attention.{p}"] = n
    counts["rglru_scan"] = rglru_scan.launches
    for p, n in rglru_scan.launches_by_path.items():
        counts[f"rglru_scan.{p}"] = n
    counts["ssd_scan"] = ssd_scan.launches
    for p, n in ssd_scan.launches_by_path.items():
        counts[f"ssd_scan.{p}"] = n
    return counts


def reset_lm_counts():
    import repro_torch.kernels.adamw as adamw_module
    import repro_torch.kernels.flash_attention as flash_module
    import repro_torch.kernels.rglru_scan as scan_module
    import repro_torch.kernels.ssd_scan as ssd_module
    for module in (flash_module, scan_module, ssd_module, adamw_module):
        module.reset_launches()


def flash_launches(n: int, kernel: str) -> dict:
    """The LM kernels' launch counts (``lm_counts``' keys) of a prefill
    whose only kernels are `n` flash launches, all on path `kernel`."""
    want = {k: 0 for k in lm_counts()}
    want["flash_attention"] = want[f"flash_attention.{kernel}"] = n
    return want


class ServeRecorder:
    """Keeps, in the order the engine admits requests, each prefill's
    last-position logits and the same logits before the model's final
    softcap (what ``unembed`` returned; the same rows where the model has
    no cap), its recurrent or SSM layers' final states h (on the host,
    f32), the LM kernels it launched and each MoE layer's routing (every
    token's experts and whether each assignment was kept under the
    capacity, on the sort dispatch); and each instance's decode steps
    taken (``decode_steps``, by iid).  With `steps`, also every step's
    logits of each request, after and before the cap (None where there
    is no cap), keyed by rid in ``by_rid``: its prefill's last position
    and its slot's row of each decode step, read from the step's outputs
    (``DecodeStep.logits`` and ``.pre``) after the step, since a replayed
    graph calls no Python.  Wraps the names the serving engine, the model
    and the MoE layer call."""

    def __init__(self, steps: bool = False):
        from collections import Counter, defaultdict
        from repro_torch.models import model as model_lib
        from repro_torch.models import moe as moe_mod
        from repro_torch.serving.engine import ServingInstance
        self.logits, self.pre, self.states = [], [], []
        self.launches, self.routes = [], []
        self.by_rid = defaultdict(list)
        self.decode_steps = Counter()
        self._routing, self._unembedded, self._rid = None, None, None
        self._patched = []

        def patch(owner, name, wrap):
            orig = getattr(owner, name)
            self._patched.append((owner, name, orig))
            setattr(owner, name, wrap(orig))

        def rows(cfg, logits, pre, rids):
            got = logits.float().cpu()
            pre = pre.float().cpu() if cfg.logit_softcap else got
            for i, rid in enumerate(rids):
                if steps and rid is not None:
                    self.by_rid[rid].append(
                        (got[i], None if pre is got else pre[i]))
            return got, pre

        def router(orig):
            def call(params, x2d, moe):
                w, idx, gates = orig(params, x2d, moe)
                if self._routing is not None:
                    pos = moe_mod._positions_in_expert(idx, moe.n_experts)
                    keep = pos < moe_mod._capacity(idx.shape[0], moe)
                    self._routing.append((idx, keep))
                return w, idx, gates
            return call

        def unembed(orig):
            def call(table, h):
                self._unembedded = orig(table, h)
                return self._unembedded
            return call

        def prefill(orig):
            def call(cfg, *args, **kw):
                n0 = lm_counts()
                self._routing = []
                try:
                    logits, cache = orig(cfg, *args, **kw)
                finally:
                    routing, self._routing = self._routing, None
                self.launches.append({k: n - n0[k]
                                      for k, n in lm_counts().items()})
                got, pre = rows(cfg, logits, self._unembedded[:, -1],
                                [self._rid])
                self.logits.append(got[0])
                self.pre.append(pre[0])
                self.states.append([c["h"][0].float().cpu() for c in cache
                                    if "h" in c])
                self.routes.append(routing)
                return logits, cache
            return call

        def admit(orig):
            def call(inst, req):
                self._rid = req.rid
                return orig(inst, req)
            return call

        def step(orig):
            def call(inst):
                rids = [None if r is None else r.rid for r in inst.active]
                done = orig(inst)
                if any(r is not None for r in rids):
                    self.decode_steps[inst.iid] += 1
                    if steps:
                        rows(inst.cfg, inst.decoder.logits,
                             inst.decoder.pre, rids)
                return done
            return call

        patch(moe_mod, "_router", router)
        patch(model_lib, "unembed", unembed)
        patch(model_lib, "prefill", prefill)
        patch(ServingInstance, "admit", admit)
        patch(ServingInstance, "step", step)

    def close(self):
        for owner, name, orig in reversed(self._patched):
            setattr(owner, name, orig)


def _serve(cfg, params, prompts, use_kernel: bool,
           max_len: int = SERVE_MAX_LEN):
    """One engine, one instance, every prompt submitted at once and
    drained; the kernels' run (`use_kernel`) decodes through the captured
    step, the plain run eagerly (``graph=False``), the yardstick.
    Returns (requests, the recorder, launches, seconds, peak bytes, the
    instance's decode step)."""
    import torch
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, slots=SERVE_SLOTS,
                        max_len=max_len, use_kernel=use_kernel,
                        graph=use_kernel)
    eng.scale_up(1)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p.copy(), SERVE_MAX_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = ServeRecorder()
    reset_lm_counts()
    try:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rec.close()
    launches = lm_counts()
    (inst,) = eng.instances.values()
    return (sorted(done, key=lambda r: r.rid), rec, launches, wall,
            torch.cuda.max_memory_allocated(), inst.decoder)


def _profiled(phase: str, label: str, run, prompt_len: int):
    """`run` once under torch.profiler (host and device activity): prints
    its wall time, device busy time and idle share and the largest
    entries by device and by host time; returns (the profiler's rows, the
    device rows), None without device time ("not measured")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy <= 0:
        print(f"{phase} profile {label}: device time not measured")
        return None
    top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
    print(f"{phase} profile {label} (prompt {prompt_len}, profiled "
          f"{wall * 1e3:.1f} ms): device busy {busy * 1e3:.2f} ms, "
          f"idle share {1 - busy / wall:.4f}; {len(host)} host op "
          f"kinds, {sum(e.count for e in host)} host op calls")
    print(f"{phase} profile   device: " + "; ".join(
        f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} "
        f"ms" for e in top_dev))
    print(f"{phase} profile   host: " + "; ".join(
        f"{e.key[:32]} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
        for e in top_host))
    return host, dev


def profile_serving(cfg, params, prompt, phase: str, first_ms=None,
                    max_len: int = SERVE_MAX_LEN):
    """One prefill of `prompt` into a fresh instance, one decode step to
    capture its graph, then one replayed decode step and one eager step
    on the same cache, each under torch.profiler (``_profiled``: wall
    time, device busy share, the largest entries by device and by host
    time); the flash and RG-LRU scan kernels' device time in the
    prefill, each beside `first_ms[name]` (the first kernel's phase-4
    device time at the same shape, times the launches) where given.  A
    measurement only; prints "not measured" without device time."""
    from repro_torch.serving.engine import (DecodeStep, Request,
                                            ServingInstance)
    inst = ServingInstance(cfg, params, slots=SERVE_SLOTS,
                           max_len=max_len)
    got = _profiled(phase, "prefill", lambda: inst.admit(
        Request(0, prompt.copy(), SERVE_MAX_NEW)), len(prompt))
    inst.step()
    _profiled(phase, "decode step (graph replay)", inst.step, len(prompt))
    eager = DecodeStep(cfg, params, inst.cache, SERVE_SLOTS, max_len,
                       inst.device, graph=False)
    _profiled(phase, "decode step (eager)",
              lambda: eager(inst.last_token, inst.pos), len(prompt))
    inst.close()
    if got is None:
        return
    host, dev = got
    # device time by the host op that launched it
    ops = sorted((e for e in host if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    print(f"{phase} profile   device time by op: " + "; ".join(
        f"{e.key[:24]} x{e.count} "
        f"{e.self_device_time_total / 1e3:.2f} ms" for e in ops))
    ssd = [e for e in dev if "ssd_" in e.key]
    if ssd:
        print(f"{phase} profile   ssd: " + "; ".join(
            f"{e.key[:40]} x{e.count} "
            f"{e.self_device_time_total / 1e3:.2f} ms" for e in ssd))
    for name, key in (("flash", "flash"), ("scan", "rglru")):
        mine = [e for e in dev if key in e.key]
        if not mine:
            continue
        first = (first_ms or {}).get(name)
        ref_text = ("" if first is None else
                    f"; the first kernel at this shape in phase 4, "
                    f"times the launches: {first:.2f} ms")
        print(f"{phase} profile   {name}: " + "; ".join(
            f"{e.key[:40]} x{e.count}" for e in mine) + ", device "
            f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} "
            f"ms{ref_text}")


def hold_graph(label: str, cfg, params, graphed, tokens, pos,
               steps: int = HOLD_STEPS) -> dict:
    """The graph-against-eager hold: `graphed`, a captured decode step
    (``DecodeStep``) on its cache after its prefills, and an eager one on
    a bitwise copy of that cache, `steps` greedy steps each from the
    slots' `tokens` at positions `pos` (host int64 arrays), in turn: the
    tokens equal at every step of every slot; the logits' largest
    difference, before and after the final softcap, printed, and any
    other than 0 within LOGIT_TOL of the largest |logit|; one replay a
    step.  Each step timed on the host clock (the step reads its tokens
    back, so it ends synchronised); decode tokens/s of both over the
    steps after the first (the graphed one's first captures).  Returns
    the measurements."""
    import torch
    from repro_torch.serving.engine import DecodeStep
    copy = [{k: t.clone() for k, t in layer.items()}
            for layer in graphed.cache]
    eager = DecodeStep(cfg, params, copy, graphed.slots, graphed.max_len,
                       graphed.device, graph=False)
    tokens, pos = tokens.copy(), pos.copy()
    times = {"graph": [], "eager": []}
    diff = pre_diff = scale = 0.0
    torch.cuda.synchronize()
    for i in range(steps):
        t0 = time.perf_counter()
        got = graphed(tokens, pos)
        t1 = time.perf_counter()
        want = eager(tokens, pos)
        t2 = time.perf_counter()
        times["graph"].append(t1 - t0)
        times["eager"].append(t2 - t1)
        check(bool((got == want).all()), f"{label} graph hold step {i}: "
              f"tokens {got.tolist()} against eager {want.tolist()}")
        check(bool(torch.isfinite(graphed.logits).all()),
              f"{label} graph hold step {i}: logits not finite")
        diff = max(diff, float((graphed.logits.float()
                                - eager.logits.float()).abs().max()))
        pre_diff = max(pre_diff, float((graphed.pre.float()
                                        - eager.pre.float()).abs().max()))
        scale = max(scale, float(eager.logits.float().abs().max()))
        tokens, pos = got, pos + 1
    check(graphed.replays == steps, f"{label} graph hold: "
          f"{graphed.replays} replays for {steps} steps")
    check(diff <= LOGIT_TOL * scale, f"{label} graph hold: logits differ "
          f"by {diff} of max |logit| {scale}")
    n = graphed.slots * (steps - 1)
    out = {"capture_ms": graphed.capture_ms,
           "pool_bytes": graphed.pool_bytes, "max_logit_diff": diff,
           "max_pre_cap_diff": pre_diff,
           "graph_tok_s": n / sum(times["graph"][1:]),
           "eager_tok_s": n / sum(times["eager"][1:]),
           "graph_first_ms": 1e3 * times["graph"][0],
           "graph_step_ms": 1e3 * statistics.median(times["graph"][1:]),
           "eager_step_ms": 1e3 * statistics.median(times["eager"][1:])}
    print(f"{label} graph against eager, {steps} greedy steps of "
          f"{graphed.slots} slots from bitwise-equal caches: tokens equal "
          f"at every step of every slot; logits largest difference "
          f"{diff:.6g} (before the cap {pre_diff:.6g}; max |logit| "
          f"{scale:.2f}, tol {LOGIT_TOL * scale:.4f})"
          f"{'' if diff == 0 else ', not bitwise'}; "
          f"replays {graphed.replays}; capture {graphed.capture_ms:.2f} ms "
          f"(warm-up + capture; pool {graphed.pool_bytes / 2**20:.1f} "
          f"MiB), first graphed step "
          f"{out['graph_first_ms']:.2f} ms; median step graphed "
          f"{out['graph_step_ms']:.3f} ms, eager {out['eager_step_ms']:.3f} "
          f"ms; decode {out['graph_tok_s']:.2f} tokens/s graphed, "
          f"{out['eager_tok_s']:.2f} eager (steps 2-{steps})")
    del eager, copy
    return out


def hold_served_graph(phase: str, cfg, params, prompts, max_len: int,
                      steps: int = HOLD_STEPS):
    """``hold_graph`` at a phase's serving configuration: a fresh graphed
    instance (SERVE_SLOTS slots, caches of `max_len`) admits one prompt
    of each length, then the rest in turn, until its slots are full, and
    its own decode step is held against an eager one on a copy of its
    cache for `steps` steps.  Prints the peak memory of the hold (two
    caches)."""
    import torch
    from repro_torch.serving.engine import Request, ServingInstance
    inst = ServingInstance(cfg, params, slots=SERVE_SLOTS, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, p in enumerate((prompts[::2] + prompts[1::2])[:SERVE_SLOTS]):
        check(inst.admit(Request(i, p.copy(), SERVE_MAX_NEW)),
              f"{phase}: the hold's instance is full")
    lengths = [len(r.prompt) for r in inst.active]
    out = hold_graph(f"{phase} prompts {lengths}", cfg, params,
                     inst.decoder, inst.last_token, inst.pos, steps)
    print(f"{phase} graph hold peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    inst.close()
    return out


def serve_full_width(phase: str, arch: str, prompt_lengths, seed: int,
                     per_prefill: dict, layers_label: str, first_ms=None,
                     max_len: int = SERVE_MAX_LEN, f32_witness: bool = False,
                     cfg=None, param_dtype=None, n_plain: int = 0,
                     stash_rows: int = 0):
    """`arch` at its published width on the card (`cfg`, where given, is
    its config cut in depth), random weights from a seeded generator
    (f32, or `param_dtype`; the MoE router and the scans' own parameters
    stay f32), computed in the config's dtype: one ServingEngine instance
    (4 slots, caches of `max_len`) serves two requests of each prompt
    length, with the kernels and then, the first `n_plain` of them (all
    where 0: a prompt too long for the plain version's materialised
    scores is left out), with their plain versions.  Each prefill must
    launch `per_prefill` kernels; the prefills' logits, final states (of
    the recurrent or SSM layers, where the model has any) and first
    tokens must agree.  With `stash_rows`, every flash call of the
    profiled prefill (the last prompt's) is held against the plain
    version on its own q, k, v, `stash_rows` query rows at a time
    (``hold_stashed_flash``).  With MoE layers, bf16 rounding flips
    near-tied experts between the two runs: each prefill's routing is
    compared layer by layer (printed), and its logits and first token are
    held where every layer routed the last position alike, which at least
    one prefill must.  With `f32_witness`
    (a model whose own bf16 rounding moves its logits by more than
    LOGIT_TOL of the largest) the logits are held in norm instead: within
    LOGIT_TOL of the plain run's, and no farther than WITNESS_RATIO times
    the plain run's distance from the same prefill in f32 through the
    plain versions; and so are the logits before the final softcap (which
    saturates random weights' logits), which must also be within
    LOGIT_TOL of their largest |logit| and whose argmax must agree where
    the plain run's top-2 margin exceeds that.  The kernels' drain
    decodes through the instance's captured step (one replay a decode
    step), the plain drain eagerly, and both decode rates are printed;
    ``hold_served_graph`` holds a captured step against an eager one.
    Returns the kernels' launches in the kernels' run and that drain's
    peak memory (bytes)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine
    label = phase.replace("phase", "phase ")
    full = get_config(arch)
    cfg = cfg or full
    param_dtype = param_dtype or torch.float32
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        param_dtype=param_dtype)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    print(f"{phase} {arch}: {sum(t.numel() for t in leaves):,} parameters "
          f"({str(param_dtype)[6:]}, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} "
          f"GB, computed in {cfg.dtype}; the config's estimate "
          f"{cfg.param_count():,}), {cfg.n_layers} of {full.n_layers} "
          f"layers ({layers_label}), d_model {cfg.d_model}, init "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    del leaves
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lengths for _ in range(2)]
    plain = prompts[:n_plain or len(prompts)]
    # warm-up (cuBLAS handles, the kernels' first launch), not counted
    warm = ServingEngine(cfg, params, slots=1, max_len=max_len)
    warm.scale_up(1)
    warm.submit(Request(-1, prompts[0][:256].copy(), 2))
    warm.drain()
    del warm

    done, rec_k, launches, wall, peak, dec = _serve(cfg, params, prompts,
                                                    True, max_len)
    n_steps = sum(rec_k.decode_steps.values())
    print(f"{phase} decode through the captured step: {dec.replays} "
          f"replays for {n_steps} decode steps, capture "
          f"{dec.capture_ms:.2f} ms (warm-up + capture, in the drain), "
          f"the graph's pool {dec.pool_bytes / 2**20:.1f} MiB")
    check(dec.graph is not None and dec.replays == n_steps,
          f"{label}: {dec.replays} replays for {n_steps} decode steps")
    dec.close()
    del dec
    check(len(done) == len(prompts)
          and all(len(r.tokens) == SERVE_MAX_NEW for r in done),
          f"{label}: not every request finished with max_new tokens")
    want = {k: n * len(prompts) for k, n in per_prefill.items()}
    print(f"{phase} launches (kernels run): {launches}, expected {want} "
          f"({per_prefill} per prefill)")
    check(launches == want, f"{label} launches {launches} != {want}")
    check(rec_k.launches == [per_prefill] * len(prompts),
          f"{label}: launches per prefill {rec_k.launches}")
    prefill_ms = [1e3 * (r.t_first_token - r.t_admit) for r in done]
    for r, ms in zip(done, prefill_ms):
        print(f"{phase} request {r.rid}: prompt {len(r.prompt)}, prefill "
              f"{ms:.2f} ms, latency {r.latency_ms:.2f} ms, tokens "
              f"{r.tokens[:4]}...")
    n_dec = sum(len(r.tokens) - 1 for r in done)
    dec_s = wall - sum(prefill_ms) / 1e3
    print(f"{phase} drain {wall:.3f} s: prefill {sum(prefill_ms):.2f} ms "
          f"total, decode {n_dec} tokens in {dec_s:.3f} s = "
          f"{n_dec / dec_s:.2f} tokens/s (4 slots, graphed), peak memory "
          f"{peak / 2**30:.3f} GiB")
    hold_served_graph(phase, cfg, params, prompts, max_len)

    stash = FlashStash() if stash_rows else None
    try:
        profile_serving(cfg, params, prompts[-1], phase, first_ms, max_len)
    finally:
        if stash is not None:
            stash.close()
    worst_layer = None
    if stash is not None:
        n_flash = per_prefill["flash_attention"]
        check(len(stash.calls) == n_flash, f"{label}: the profiled prefill "
              f"made {len(stash.calls)} flash calls, not {n_flash}")
        worst_layer = hold_stashed_flash(
            stash.calls, f"{phase} profiled {len(prompts[-1])}-token "
            "prefill", stash_rows)
        del stash

    done_p, rec_p, launches_p, wall_p, _, dec_p = _serve(
        cfg, params, plain, False, max_len)
    n_dec_p = sum(len(r.tokens) - 1 for r in done_p)
    dec_s_p = wall_p - sum(r.t_first_token - r.t_admit for r in done_p)
    print(f"{phase} decode tokens/s, the kernels' drain (graphed) "
          f"{n_dec / dec_s:.2f}, the plain drain (eager) "
          f"{n_dec_p / dec_s_p:.2f} ({n_dec_p} tokens in {dec_s_p:.3f} s)")
    check(dec_p.graph is None and dec_p.replays == 0,
          f"{label}: the plain run's decode was captured")
    del dec_p
    check(not any(launches_p.values()),
          f"{label}: the plain run launched kernels {launches_p}")
    check(len(rec_k.logits) == len(prompts)
          and len(rec_p.logits) == len(plain),
          f"{label}: a prefill was not recorded")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    check(all(len(r) == n_moe for r in rec_k.routes + rec_p.routes),
          f"{label}: a prefill's routing was not recorded")
    flips = [[0, 0] for _ in range(n_moe)]
    worst, worst_h, n_held, n_checked, n_pre_checked = 0.0, 0.0, 0, 0, 0
    for i, lp in enumerate(rec_p.logits):
        lk = rec_k.logits[i]
        check(bool(torch.isfinite(lk).all()),
              f"{label} prefill {i}: logits not finite")
        # MoE: held where every layer routed the last position alike
        diffs = [_routing_diff(a, b)
                 for a, b in zip(rec_k.routes[i], rec_p.routes[i])]
        for j, (n_set, n_keep, _) in enumerate(diffs):
            flips[j][0] += n_set
            flips[j][1] += n_keep
        agreed = all(last for _, _, last in diffs)
        scale = float(lp.abs().max())
        err = float((lk - lp).abs().max())
        top2 = torch.topk(lp, 2).values
        margin = float(top2[0] - top2[1])
        tol = LOGIT_TOL * scale
        same = int(lk.argmax()) == int(lp.argmax())
        routed = (f"routing differs from the plain run in "
                  f"{[d[0] for d in diffs]} tokens' experts and "
                  f"{[d[1] for d in diffs]} keep flags by MoE layer, the "
                  f"last position agrees by layer "
                  f"{[int(d[2]) for d in diffs]}; " if n_moe else "")
        held = ("not held: routing differs" if not agreed else
                "not held" if f32_witness else "held")
        print(f"{phase} prefill {i} (prompt {len(prompts[i])}): {routed}"
              f"logits max_abs_err {err:.4f} of max |logit| {scale:.2f} "
              f"(tol {tol:.4f}, {held}); top-2 margin {margin:.4f}; first "
              f"token same={same}")
        if not agreed:
            continue
        n_held += 1
        worst = max(worst, err / scale)
        if f32_witness:
            toks = torch.as_tensor(prompts[i][None].astype(np.int64),
                                   device=model_lib.params_device(params))
            rec_f = ServeRecorder()
            try:
                model_lib.prefill(cfg.replace(dtype="float32"), params,
                                  {"tokens": toks}, max_len,
                                  use_kernel=False)
            finally:
                rec_f.close()
            lf = rec_f.logits[0]
            kp, kf, pf = (float((a - b).norm() / b.norm())
                          for a, b in ((lk, lp), (lk, lf), (lp, lf)))
            pf_abs = float((lp - lf).abs().max())
            print(f"{phase} prefill {i} in norm: kernels against plain "
                  f"{kp:.5f} (tol {LOGIT_TOL}); against f32 {kf:.5f}, the "
                  f"plain run against f32 {pf:.5f} (tol {WITNESS_RATIO} "
                  f"times; max_abs {pf_abs:.4f}); f32 argmax "
                  f"{int(lf.argmax())}; plain logits at the largest "
                  f"|logit| {int((lp.abs() >= scale).sum())}")
            check(kp <= LOGIT_TOL and kf <= WITNESS_RATIO * pf,
                  f"{label} prefill {i}: logits {kp} from the plain run's "
                  f"and {kf} from f32 (the plain run {pf}) in norm")
            # before the final softcap, which saturates random weights'
            # logits and hides what differs before it: the same holds, phase
            # 5's (LOGIT_TOL of the largest |logit|), and the argmax where
            # the plain run's top-2 margin allows
            bk, bp, bf = rec_k.pre[i], rec_p.pre[i], rec_f.pre[0]
            kp, kf, pf = (float((a - b).norm() / b.norm())
                          for a, b in ((bk, bp), (bk, bf), (bp, bf)))
            pre_scale = float(bp.abs().max())
            pre_err = float((bk - bp).abs().max())
            top2 = torch.topk(bp, 2).values
            pre_margin = float(top2[0] - top2[1])
            pre_same = int(bk.argmax()) == int(bp.argmax())
            print(f"{phase} prefill {i} before the cap: kernels against "
                  f"plain {kp:.5f} in norm (tol {LOGIT_TOL}), max_abs_err "
                  f"{pre_err:.4f} of max |logit| {pre_scale:.2f} (tol "
                  f"{LOGIT_TOL * pre_scale:.4f}); against f32 {kf:.5f}, "
                  f"the plain run against f32 {pf:.5f} (tol "
                  f"{WITNESS_RATIO} times); top-2 margin {pre_margin:.4f}; "
                  f"argmax same={pre_same}")
            check(kp <= LOGIT_TOL and kf <= WITNESS_RATIO * pf
                  and pre_err <= LOGIT_TOL * pre_scale,
                  f"{label} prefill {i}: logits before the cap {kp} from "
                  f"the plain run's and {kf} from f32 (the plain run {pf}) "
                  f"in norm, {pre_err} at most of {pre_scale}")
            if pre_margin > LOGIT_TOL * pre_scale:
                n_pre_checked += 1
                check(pre_same, f"{label} prefill {i}: the argmax before "
                      "the cap differs")
        else:
            check(err <= tol, f"{label} prefill {i}: logits differ by {err}")
        # the scan's output itself: each recurrent or SSM layer's final
        # state, relative in norm (the logits are dominated by the
        # embedding); attention-only models have none
        h_err = max((float((hk - hp).norm() / hp.norm())
                     for hk, hp in zip(rec_k.states[i], rec_p.states[i])),
                    default=0.0)
        worst_h = max(worst_h, h_err)
        check(h_err <= LOGIT_TOL, f"{label} prefill {i}: states differ by "
              f"{h_err} in norm")
        if margin > tol:
            n_checked += 1
            check(same, f"{label} prefill {i}: first token differs")
    held = (f"logits held on {n_held} of {len(plain)} prefills (of "
            f"{len(prompts)}; worst {worst:.5f} of max |logit|), first "
            f"token checked on {n_checked}"
            + (f", the argmax before the cap on {n_pre_checked}"
               if f32_witness else "")
            + ("" if worst_layer is None else
               f"; the profiled prefill's flash outputs at worst "
               f"{worst_layer:.3g} of their allowance"))
    if n_moe:
        print(f"{phase} routing decisions that differ between the kernels' "
              f"and the plain run, summed over the {len(plain)} prefills, "
              "by MoE layer (tokens whose expert set differs / assignments "
              "whose keep flag differs): " + "; ".join(
                  f"layer {j + 1} {a} / {b}"
                  for j, (a, b) in enumerate(flips)))
        check(n_held > 0, f"{label}: no prompt's routing agreed at its last "
              "position, so no logits were held")
    # how the state error grows with depth: bf16 rounding of each layer's
    # output, which the two runs do at other places, adds up layer by layer
    n_layers = len(rec_k.states[0])
    if not n_layers:
        print(f"{phase} plain run: drain {wall_p:.3f} s; {held}; no "
              "recurrent or SSM state")
        return launches, peak
    by_depth = [max(float((rec_k.states[i][j] - rec_p.states[i][j]).norm()
                          / rec_p.states[i][j].norm())
                    for i in range(len(plain))) for j in range(n_layers)]
    marks = sorted({0, n_layers // 4, n_layers // 2, n_layers - 1})
    print(f"{phase} state error by layer (worst over prefills): " + "; ".join(
        f"layer {j + 1} {by_depth[j]:.5f}" for j in marks))
    print(f"{phase} state error by layer as a share of the {LOGIT_TOL} "
          "limit, layers 1 to " f"{n_layers}: " + " ".join(
              f"{e / LOGIT_TOL:.3f}" for e in by_depth))
    print(f"{phase} plain run: drain {wall_p:.3f} s; {held}; worst state "
          f"error {worst_h:.5f} in norm over {n_layers} layers")
    return launches, peak


def _leaves(tree):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _free_models(label: str):
    """Frees what earlier phases left (their models, the allocator's
    cache) and prints what stays allocated."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} before init: {torch.cuda.memory_allocated() / 2**30:.3f} "
          "GiB allocated")


def phase5_serving(flash_first_ms: float, scan_first_ms: float):
    """recurrentgemma-2b: 8 flash launches per prefill, all on the
    tensor-core path (bf16, head dim 256), and 18 RG-LRU scans, all on
    the TMA path.  The first kernels' phase-4 device times at the longest
    prompt, times the launches, stand beside the profiled prefill's."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    kinds = get_config(SERVE_ARCH).layer_kinds()
    n_local, n_rec = kinds.count("local"), kinds.count("recurrent")
    launches, _ = serve_full_width(
        "phase5", SERVE_ARCH, SERVE_PROMPTS, 5,
        {"flash_attention": n_local, "flash_attention.wgmma": n_local,
         "flash_attention.tf32": 0, "flash_attention.simt": 0,
         "rglru_scan": n_rec, "rglru_scan.tma": n_rec,
         "rglru_scan.simt": 0, "ssd_scan": 0, "ssd_scan.wgmma": 0,
         "ssd_scan.tf32": 0, "ssd_scan.simt": 0},
        f"{n_local} local + {n_rec} recurrent",
        {"flash": n_local * flash_first_ms, "scan": n_rec * scan_first_ms})
    print(f"phase5 total {time.perf_counter() - t0:.1f} s")
    return launches


def phase6_ssm_serving():
    """mamba2-2.7b, after phase 5's model is freed: 64 SSD scan launches
    per prefill, all on the tensor-core path (bf16, head dim 64, d_state
    128)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    _free_models("phase6")
    cfg = get_config(SSM_ARCH)
    n_ssm = cfg.layer_kinds().count("ssm")
    check(n_ssm == cfg.n_layers == 64 and cfg.d_model == 2560,
          f"phase 6: {SSM_ARCH} is {cfg.n_layers} layers ({n_ssm} SSM) of "
          f"{cfg.d_model}")
    launches, _ = serve_full_width(
        "phase6", SSM_ARCH, SSM_PROMPTS, 6,
        {"flash_attention": 0, "flash_attention.wgmma": 0,
         "flash_attention.tf32": 0, "flash_attention.simt": 0,
         "rglru_scan": 0, "rglru_scan.tma": 0, "rglru_scan.simt": 0,
         "ssd_scan": n_ssm, "ssd_scan.wgmma": n_ssm, "ssd_scan.tf32": 0,
         "ssd_scan.simt": 0},
        f"{n_ssm} SSM, {cfg.ssd.n_heads(cfg.d_model)} heads of "
        f"{cfg.ssd.head_dim}, d_state {cfg.ssd.d_state}")
    print(f"phase6 total {time.perf_counter() - t0:.1f} s")
    return launches


class FlashStash:
    """While open, keeps every (q, k, v, out, mask) that the model layers
    hand to the flash kernel (``ops.flash_attention_fn``), so each call's
    output can be held against the plain version afterwards, outside the
    profiled window."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.flash_attention_fn
        self.calls = []

        def stash(q, k, v, **kw):
            out = self.orig(q, k, v, **kw)
            self.calls.append((q, k, v, out, kw))
            return out

        ops.flash_attention_fn = stash

    def close(self):
        self.ops.flash_attention_fn = self.orig


def hold_stashed_flash(calls, label: str, rows: int = 16) -> float:
    """Each stashed bf16 flash output against the plain version on the
    same q, k, v (`rows` query rows at a time, to bound the plain
    version's scores), within ATTN_TOL; returns the worst element's share
    of its allowance."""
    import torch
    from repro_torch.kernels import ref
    first, second = ATTN_TOL["bfloat16"]
    worst_all = 0.0
    for j, (q, k, v, out, kw) in enumerate(calls):
        group = q.shape[0] // k.shape[0]
        worst, err = 0.0, 0.0
        for r0 in range(0, q.shape[0], rows):
            qs = q[r0:r0 + rows]
            ks = k.repeat_interleave(group, 0)[r0:r0 + rows]
            vs = v.repeat_interleave(group, 0)[r0:r0 + rows]
            want = ref.flash_attention_ref(qs, ks, vs, **kw).float()
            avg_abs_v = ref.flash_attention_ref(qs, ks, vs.abs(), **kw)
            diff = (out[r0:r0 + rows].float() - want).abs()
            allowed = first * want.abs() + second * avg_abs_v.float()
            err = max(err, float(diff.max()))
            worst = max(worst, float((diff / allowed).max()))
        print(f"{label} layer {j} flash kernel against plain on its own q "
              f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
              f"max_abs_err {err:.3g}, worst element {worst:.3g} of the "
              f"allowance")
        check(worst <= 1.0, f"{label} layer {j}: the flash kernel is "
              f"{worst:.3g} of its allowance from the plain version")
        worst_all = max(worst_all, worst)
    return worst_all


def _routing_diff(rk, rp):
    """One MoE layer's routing in two runs, (experts, kept) each: the
    tokens whose expert set differs, the assignments whose keep flag
    differs (of tokens whose set agrees), and whether the last position's
    experts and keep flags agree."""
    import torch
    ik, kk = (t.cpu() for t in rk)
    ip, kp = (t.cpu() for t in rp)
    sk, ordk = torch.sort(ik, dim=-1)
    sp, ordp = torch.sort(ip, dim=-1)
    keep_k, keep_p = kk.gather(1, ordk), kp.gather(1, ordp)
    set_diff = (sk != sp).any(dim=-1)
    keep_diff = (keep_k != keep_p) & ~set_diff[:, None]
    last = not bool(set_diff[-1]) and bool((keep_k[-1] == keep_p[-1]).all())
    return int(set_diff.sum()), int(keep_diff.sum()), last


def phase6b_moe_serving():
    """deepseek-v2-236b at its published width, depth cut to MOE_LAYERS
    (the dense first layer and six MoE layers), bf16 weights (the router
    f32) from a seeded generator, after phase 6's model is freed, served
    as phase 5 serves (``serve_full_width``): every prefill launches one
    flash kernel a layer, all on the wgmma path (q and k of head dim 192,
    v of 128); the profiled 3,000-token prefill's flash outputs are held
    against the plain version on the same q, k, v; the plain run's
    routing is compared layer by layer, and the logits and first tokens
    of every prompt whose routing agreed at its last position in every
    layer are held as in phase 5.  Returns the launches of the kernels'
    run."""
    import gc
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    _free_models("phase6b")
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    m, moe = cfg.mla, cfg.moe
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    check((cfg.d_model, cfg.n_heads, m.q_lora_rank, m.kv_lora_rank,
           m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim,
           moe.n_experts, moe.top_k, moe.d_ff_expert, moe.n_shared_experts,
           cfg.vocab_size, n_moe) == (5120, MLA_HEADS, 1536, 512,
                                      MLA_QK_DIM, MLA_V_DIM, 160, 6, 1536,
                                      2, 102400, MOE_LAYERS - 1),
          f"phase 6 (b): {MOE_ARCH} is not at its published width")
    launches, _ = serve_full_width(
        "phase6b", MOE_ARCH, SERVE_PROMPTS, 7,
        flash_launches(cfg.n_layers, "wgmma"),
        f"1 dense + {n_moe} MoE; MLA ranks {m.q_lora_rank} / "
        f"{m.kv_lora_rank}; {moe.n_experts} experts top-{moe.top_k} of "
        f"d_ff {moe.d_ff_expert}, {moe.n_shared_experts} shared; dispatch "
        f"{moe.dispatch}, capacity factor {moe.capacity_factor}",
        cfg=cfg, param_dtype=torch.bfloat16, stash_rows=16)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase6b total {time.perf_counter() - t_phase:.1f} s; after: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the platform facade
# ---------------------------------------------------------------------------


def _launches() -> dict:
    from repro_torch.kernels.rfr_inference import (rfr_capacity_sweep,
                                                   rfr_forest_apply)
    return {"rfr_forest_apply": rfr_forest_apply.launches,
            "rfr_capacity_sweep": rfr_capacity_sweep.launches}


def _controllers(sim) -> list:
    """A run's admission controllers, one per cell."""
    cells = getattr(sim, "cells", None)
    if cells is None:
        return [sim.admission]
    return [c.autoscaler.admission for c in cells]


def _differing(got: dict, want: dict) -> list:
    return [k for k in want if got[k] != want[k]]


def phase7_smoke():
    """(a) The port's smoke() (every registered scheduler from manifest
    dicts, 30 ticks, 8 target nodes) on the card, then the same
    manifests on engine "numpy": every scheduler's outcome equal.  Each
    run's launches are counted from 0 (the run is wrapped to read
    them); the numpy runs launch nothing."""
    import torch
    from repro_torch.core import platform as core_platform
    from repro_torch.kernels.rfr_inference import reset_launches
    cls = core_platform.Platform
    runs = []
    orig_run = cls.run

    def counted_run(self, duration_s=None):
        reset_launches()
        res = orig_run(self, duration_s)
        torch.cuda.synchronize()
        runs.append((self.config, outcome(res, self.simulation),
                     _launches()))
        return res

    cls.run = counted_run
    try:
        t0 = time.perf_counter()
        core_platform.smoke()
        wall_card = time.perf_counter() - t0
        card, runs = runs, []
        t0 = time.perf_counter()
        scenario = world = None
        for cfg, _out, _l in card:
            manifest = cfg.to_dict()
            check(manifest["prediction"]["engine"] is None,
                  "phase 7: smoke() set an engine")
            manifest["prediction"]["engine"] = "numpy"
            plat = cls.build(scenario=scenario, config=manifest,
                             world=world)
            scenario, world = plat.scenario, plat.world
            world.gt.reseed()
            plat.run()
        wall_numpy = time.perf_counter() - t0
    finally:
        cls.run = orig_run
    check(len(runs) == len(card) > 0, "phase 7: smoke runs missing")
    for (cfg, out, launches), (_c, want, l_np) in zip(card, runs):
        name = cfg.scheduler.name
        diff = _differing(out, want)
        print(f"phase7 smoke {name}: density {out['density']!r}, "
              f"qos_violation_rate {out['qos_violation_rate']!r}, sched "
              f"{out['sched']}, launches {launches}; engine numpy: "
              f"differing fields {diff or 'none'}")
        check(not diff, f"phase 7 smoke {name}: the card's run differs "
              f"from numpy in {diff}")
        check(not any(l_np.values()), f"phase 7 smoke {name}: the numpy "
              "run launched a kernel")
    total = {k: sum(l[k] for _c, _o, l in card) for k in card[0][2]}
    print(f"phase7 smoke: {len(card)} schedulers, card {wall_card:.2f} s, "
          f"numpy {wall_numpy:.2f} s, launches on the card {total}")
    check(total["rfr_forest_apply"] > 0,
          "phase 7 smoke never launched the forest kernel")


def phase7_control_plane():
    """(b) SCENARIO through Platform.build in PLATFORM_CELLS cells with
    admission on, on one shared world (reseeded before each run): b1
    jiagu on engine numpy (the oracle), b2 the same on engine "cuda",
    b3 jiagu-device-drain on "cuda".  b2 and b3 equal b1 in every
    outcome and every node's table; conservation within
    CONSERVATION_TOL; b2 launches the forest kernel, b3 the sweep."""
    import torch
    from repro_torch.core.platform import Platform
    from repro_torch.kernels.rfr_inference import reset_launches
    base = {"scenario": {"kind": "burst-storm", **SCENARIO},
            "cells": {"count": PLATFORM_CELLS},
            "admission": {"enabled": True}}
    runs = {}
    scenario = world = None
    for label, name, engine, drain in (
            ("b1", "jiagu", "numpy", "host"),
            ("b2", "jiagu", "cuda", "host"),
            ("b3", "jiagu-device-drain", "cuda", "device")):
        manifest = {**base, "scheduler": {"name": name},
                    "prediction": {"engine": engine}}
        t0 = time.perf_counter()
        plat = Platform.build(scenario=scenario, config=manifest,
                              world=world)
        build_s = time.perf_counter() - t0
        scenario, world = plat.scenario, plat.world
        sim = plat.simulation
        check(len(sim.cells) == PLATFORM_CELLS,
              f"phase 7 {label}: {len(sim.cells)} cells")
        check(all(s.cfg.drain == drain and s.inference_engine == engine
                  for s in sim.services()),
              f"phase 7 {label}: a cell's service is not {engine}/{drain}")
        world.gt.reseed()
        reset_launches()
        t0 = time.perf_counter()
        res = plat.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launches()
        out = outcome(res, sim)
        worst = max(c.conservation_error() for c in _controllers(sim))
        print(f"phase7 run ({label}) {name} engine={engine} drain={drain} "
              f"cells={PLATFORM_CELLS} admission on: build {build_s:.2f} s, "
              f"run {run_s:.2f} s, density {out['density']!r}, "
              f"qos_violation_rate {out['qos_violation_rate']!r}, "
              f"nodes_peak {out['nodes_peak']}, sched {out['sched']}, "
              f"scaling {out['scaling']}, class rates "
              f"{out['class_violation_rates']}, dropped "
              f"{out['dropped_requests']!r}, conservation error {worst:.3g}"
              f", launches {launches}")
        check(res.ticks == SCENARIO["duration_s"] and res.sched.decisions,
              f"phase 7 {label}: the run did not schedule")
        check(out["class_requests"], f"phase 7 {label}: admission idle")
        check(worst < CONSERVATION_TOL,
              f"phase 7 {label}: conservation error {worst}")
        runs[label] = (out, launches)
    oracle, l_b1 = runs["b1"]
    check(not any(l_b1.values()), "phase 7 b1 (numpy) launched a kernel")
    for label in ("b2", "b3"):
        got = runs[label][0]
        diff = _differing(got, oracle)
        n_tables = sum(x != y for x, y in zip(got["tables"],
                                               oracle["tables"]))
        print(f"phase7 run ({label}) vs oracle (b1): differing fields "
              f"{diff or 'none'}; nodes with differing tables {n_tables} "
              f"of {len(oracle['tables'])}")
        check(not diff, f"phase 7 {label} differs from b1 in {diff}")
    check(runs["b2"][1]["rfr_forest_apply"] > 0,
          "phase 7 b2 never launched the forest kernel")
    check(runs["b3"][1]["rfr_capacity_sweep"] > 0,
          "phase 7 b3 never launched the sweep kernel")
    return scenario, world, {label: l for label, (_o, l) in runs.items()}


def phase7_learned(scenario, world):
    """(c) The learned stack at SCENARIO's size, one cell, on the card:
    the policy installed from a PolicyStore in a temporary directory,
    each scored batch recorded and held to np_scores (SCORE_TOL, the
    same argmax wherever the top-2 margin exceeds it); no stale
    serve."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.platform import Platform
    from repro_torch.kernels.rfr_inference import reset_launches
    from repro_torch.policy import (PolicyStore, forward, init_params,
                                    load_traces, matrices, normalization,
                                    np_scores)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 7 (c): TF32 matmuls are on; the scores need full f32")
    ds = load_traces(str(ROOT / POLICY_TRACES))
    x_all, mask, _y = matrices(ds)
    policy = init_params(ds.n_features, POLICY_HIDDEN, POLICY_SEED)
    policy["mu"], policy["sd"] = normalization(x_all, mask)
    batches = []        # (rows, scores, host-inclusive seconds)
    with tempfile.TemporaryDirectory() as store:
        PolicyStore(store).save(policy, epoch=0, mode="init",
                                feature_names=ds.feature_names)
        plat = Platform.build(scenario=scenario, world=world, config={
            "scenario": {"kind": "burst-storm", **SCENARIO},
            "scheduler": {"name": "learned"},
            "prediction": {"engine": "cuda"}, "policy": {"store": store}})
        scorer = plat.scheduler.learned_scorer
        check(scorer.policy is not None
              and scorer._weights["w1"].is_cuda,
              "phase 7 (c): the policy is not on the card")
        inner = scorer.scores

        def recorded(rows):
            t0 = time.perf_counter()
            out = inner(rows)
            batches.append((rows, out, time.perf_counter() - t0))
            return out

        scorer.scores = recorded
        world.gt.reseed()
        reset_launches()
        t0 = time.perf_counter()
        res = plat.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = _launches()
    check(batches, "phase 7 (c): the learned scorer scored no batch")
    out = outcome(res, plat.simulation)
    worst, flips, clear, np_s = 0.0, 0, 0, []
    for rows, got, _s in batches:
        t0 = time.perf_counter()
        want = np_scores(policy, rows)
        np_s.append(time.perf_counter() - t0)
        worst = max(worst, float(np.abs(got - want).max()))
        if len(want) > 1:
            top2 = np.sort(want)[-2:]
            if top2[1] - top2[0] > SCORE_TOL:
                clear += 1
                flips += int(got.argmax() != want.argmax())
    n_rows = sum(len(r) for r, _g, _s in batches)
    # the forward alone at the median batch's rows, its input already on
    # the card: host and device, then the device's work alone
    rows = sorted((r for r, _g, _s in batches), key=len)[len(batches) // 2]
    x = torch.from_numpy(rows).cuda()
    fwd_ms = time_ms(lambda: forward(scorer._weights, x))
    fwd_dev_ms = time_ms(lambda: forward(scorer._weights, x), queued=True)
    print(f"phase7 learned: run {run_s:.2f} s, density {out['density']!r}, "
          f"qos_violation_rate {out['qos_violation_rate']!r}, nodes_peak "
          f"{out['nodes_peak']}, sched {out['sched']}, scaling "
          f"{out['scaling']}, launches {launches}; scorer "
          f"{scorer.stats.snapshot()}; {len(batches)} batches, {n_rows} "
          f"rows (largest {max(len(r) for r, _g, _s in batches)}"
          f"), worst |score - np_scores| {worst:.3g} (limit {SCORE_TOL}), "
          f"argmax differs in {flips} of {clear} batches with a top-2 "
          f"margin above it; per batch, median: card "
          f"{statistics.median(s for _r, _g, s in batches) * 1e3:.4f} ms "
          f"(host-inclusive), np_scores {statistics.median(np_s) * 1e3:.4f}"
          f" ms; forward alone at the median batch ({len(rows)} rows, on "
          f"the card): {fwd_ms:.4f} ms (device {fwd_dev_ms:.4f} ms)")
    scorer_split(scorer._weights, [r for r, _g, _s in batches])
    check(worst <= SCORE_TOL, f"phase 7 (c): scores {worst} from numpy")
    check(flips == 0, f"phase 7 (c): argmax differs in {flips} batches")
    check(scorer.stats.stale_serves == 0, "phase 7 (c): stale serves")
    check(launches["rfr_forest_apply"] > 0,
          "phase 7 (c) never launched the forest kernel")
    return launches


def scorer_split(weights, batches):
    """The learned scorer's batch, replayed on the run's batches and split
    as ``LearnedScorer.scores`` does the work: the copy in
    (``torch.from_numpy(rows).to(device)``), the forward, and the copy
    out with its synchronisation (``.cpu().numpy()``), each between CUDA
    events recorded around it, so host and device together, as the
    scorer meets them.  Medians overall and by batch length; printed."""
    import torch
    from repro_torch.policy import forward
    dev = weights["w1"].device
    parts = []                     # (rows, copy in, forward, copy out) ms
    for rows in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.from_numpy(rows).to(dev)
        ev[1].record()
        y = forward(weights, x)
        ev[2].record()
        y.cpu().numpy()
        ev[3].record()
        ev[3].synchronize()
        parts.append((len(rows),) + tuple(ev[i].elapsed_time(ev[i + 1])
                                          for i in range(3)))

    def line(sel):
        if not sel:
            return "none"
        med = [statistics.median(p[i] for p in sel) for i in (1, 2, 3)]
        return (f"{len(sel)} batches: copy in {med[0]:.4f} ms, forward "
                f"{med[1]:.4f} ms, copy out and sync {med[2]:.4f} ms "
                f"(sum {sum(med):.4f})")

    print(f"phase7 learned scorer batch split, median, {line(parts)}")
    for lo, hi in ((1, 64), (65, 256), (257, 512), (513, 1024),
                   (1025, 1 << 30)):
        sel = [p for p in parts if lo <= p[0] <= hi]
        if sel:
            print(f"phase7 learned scorer split, batches of {lo}-"
                  f"{min(hi, max(p[0] for p in sel))} rows: {line(sel)}")


def phase7_platform():
    phase7_smoke()
    scenario, world, launches = phase7_control_plane()
    launches["c"] = phase7_learned(scenario, world)
    return launches


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------


def flash_bwd_bound(bh: int, bh_kv: int, s: int, d: int, dtype, pairs: int,
                    dv=None):
    """q, o, dO and k, v read once, dq, dk, dv written once; 6*D + 4*Dv
    operations (five products: s, dq, dk of 2*D, dp, dv of 2*Dv; 10*D
    where Dv = D) per query-key pair the mask keeps, at the tensor-core
    rate for the inputs' type.  q, k, dq, dk have D columns, v, o, dO,
    dv Dv (D when None)."""
    import torch
    dv = d if dv is None else dv
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (bh + bh_kv) * 2 * (d + dv) * s * esize
    return bound(nbytes, (6 * d + 4 * dv) * bh * pairs, matmul_peak(dtype))


def simt_flash_bwd(q, k, v, o, do, kw):
    """The first backward kernel (csrc/flash_attention_bwd.cu: row
    statistics, dQ and dK/dV on the CUDA cores) called directly, so that
    it can be held and timed on the bf16 and f32 inputs the wrapper sends
    to the tensor-core kernels; not counted in the wrapper's launches."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import KINDS
    bh, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, bh, s), dtype=torch.float32, device=q.device)
    err = _build.load("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), bh, s, d, v.shape[2],
        bh // k.shape[0], int(q.dtype == torch.bfloat16),
        int(kw.get("causal", True)), KINDS[kw.get("kind", "global")],
        int(kw.get("window", 0)), float(kw.get("softcap", 0.0)),
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention_bwd (simt, direct)")
    return dq, dk, dv


def hold_flash_bwd(q, k, v, kw, timed: bool, twice: bool = False,
                   plain_kv_rows: int = 0):
    """flash_attention_bwd against its plain version on the forward
    kernel's output and a random dO: each of dq, dk, dv within BWD_TOL
    (its worst element printed as a share of its allowance), on the path
    ``bwd_path`` names; on the tensor-core paths (wgmma, tf32) the
    forward's lse within LSE_TOL of the plain lse, and the first kernel
    held on the same inputs.  With `twice`, a second call bitwise equal
    to the first.  With `timed`, the kernel (and on the tensor-core paths
    the first kernel), its plain version and sdpa's backward (forward and
    backward through torch.autograd.grad, minus its forward, with the
    same boolean mask, k and v repeated where 1 < G < BH; ``library_ms``
    as called, ``library_device_ms`` queued as every ``device_ms``)
    timed, and the bound; with a softcap, which sdpa does not take, the
    library is one compiled flex_attention call and its backward
    (``flex_library_bwd``).  With
    `plain_kv_rows`, the plain version runs on that many kv rows (and
    their query rows) at a time, the same function in pieces (llama4's
    S of 10,000 would hold scores of 16 GB a tensor at once).  Returns a
    dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (LSE_BWD_PATHS,
                                                     bwd_path,
                                                     flash_attention,
                                                     flash_attention_bwd)
    bh, s, d = q.shape
    dv = v.shape[2]
    dt = str(q.dtype).split(".")[-1]
    what = f"flash_attention_bwd S={s} D={d} Dv={dv} {dt} {kw}"
    rel, of_max = BWD_TOL[dt]
    kernel = bwd_path(q.dtype, d, kw.get("softcap", 0.0), dv)
    out = {"errors": {}, "max_abs_err": 0.0, "path": kernel}
    if kernel in LSE_BWD_PATHS:
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        lse_err = float((lse - ref.flash_attention_lse_ref(q, k, **kw))
                        .abs().max())
        out["lse_err"] = lse_err
        check(lse_err <= LSE_TOL, f"{what}: the forward's lse is "
              f"{lse_err} from the plain lse (limit {LSE_TOL})")
    else:
        o, lse = flash_attention(q, k, v, **kw), None
    do = torch.randn((bh, s, dv), device=q.device,
                     generator=torch.Generator(device=q.device).manual_seed(
                         s)).to(q.dtype)

    def plain_bwd():
        if not plain_kv_rows:
            return ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        g, rows = bh // k.shape[0], plain_kv_rows
        parts = []
        for j in range(0, k.shape[0], rows):
            qr = slice(j * g, (j + rows) * g)
            parts.append(ref.flash_attention_bwd_ref(
                q[qr], k[j:j + rows], v[j:j + rows], o[qr], do[qr], **kw))
        return tuple(torch.cat(p, 0) for p in zip(*parts))

    n0 = dict(flash_attention_bwd.launches_by_path)
    got = flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = plain_bwd()
    torch.cuda.synchronize()
    ran = [p for p, n in flash_attention_bwd.launches_by_path.items()
           if n != n0[p]]
    check(ran == [kernel], f"{what}: ran {ran}, bwd_path says {kernel}")

    def held(grads, label):
        errors = {}
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()),
                  f"{what} ({label}): {name} not finite")
            diff = (g - w).abs()
            worst = float((diff / (rel * w.abs() + of_max * float(
                w.abs().max()))).max())
            err = float(diff.max())
            errors[name] = (err, worst)
            check(worst <= 1.0, f"{what} ({label}): {name} max_abs_err "
                  f"{err}, the worst element at {worst:.3g} of its "
                  "allowance")
        return errors

    out["errors"] = held(got, kernel)
    out["max_abs_err"] = max(e for e, _ in out["errors"].values())
    if twice:
        again = flash_attention_bwd(q, k, v, o, do, lse, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        out["bitwise_twice"] = same
        check(same, f"{what}: two calls differ")
    if kernel != "simt":
        out["simt_errors"] = held(simt_flash_bwd(q, k, v, o, do, kw),
                                  "simt")
    if not timed:
        return out
    mask = ref.attention_mask(s, kw.get("causal", True),
                              kw.get("kind", "global"), kw.get("window", 0),
                              q.device)
    out["ms"] = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse,
                                                    **kw))
    out["device_ms"] = time_ms(
        lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw), queued=True)
    if kernel != "simt":
        out["simt_ms"] = time_ms(lambda: simt_flash_bwd(q, k, v, o, do, kw),
                                 reps=5)
        out["simt_device_ms"] = time_ms(
            lambda: simt_flash_bwd(q, k, v, o, do, kw), reps=5, queued=True)
    out["plain_ms"] = time_ms(plain_bwd, reps=5)
    if kw.get("softcap"):
        # sdpa takes no tanh softcap: one compiled flex_attention call
        library_fwd, library_both, out["library_setup_s"] = \
            flex_library_bwd(q, k, v, do, kw)
        out["library"] = "flex_attention"
    else:
        q4 = q.view(1, bh, s, d).detach().requires_grad_(True)
        group = bh // k.shape[0]
        if 1 < group < bh:
            # query head h reads kv head h // G: k and v repeated (a copy
            # made here, outside the timed calls)
            k4, v4 = (t.repeat_interleave(group, 0).view(1, bh, s, -1)
                      for t in (k, v))
        else:
            # one kv head (MQA), or one for each query head
            k4 = k.view(1, -1, s, d).expand(1, bh, s, d)
            v4 = v.view(1, -1, s, dv).expand(1, bh, s, dv)
        k4, v4 = (t.detach().requires_grad_(True) for t in (k4, v4))
        do4 = do.view(1, bh, s, dv)

        def library_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask)

        def library_both():
            return torch.autograd.grad(library_fwd(), (q4, k4, v4), do4)

        out["library"] = "sdpa"
    both = time_ms(library_both, reps=10)
    fwd = time_ms(library_fwd, reps=10)
    out["library_ms"] = both - fwd
    out["library_both_ms"] = both
    out["library_device_ms"] = (time_ms(library_both, reps=10, queued=True)
                                - time_ms(library_fwd, reps=10, queued=True))
    out["pairs"] = int(mask.sum())
    out["bound_ms"], out["bound_by"] = flash_bwd_bound(
        bh, k.shape[0], s, d, q.dtype, out["pairs"], dv)
    return out


def hold_scan_bwd(a, b, h0, timed: bool):
    """rglru_scan_bwd against its plain reverse loop, exactly (da, db and
    dh0), on the wrapper's path; with `timed` the kernel and its plain
    version timed, and the bound (a, h, dh read, da, db written)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import path, rglru_scan, rglru_scan_bwd
    what = f"rglru_scan_bwd {tuple(a.shape)} h0={h0 is not None}"
    h = rglru_scan(a, b, h0)
    dh = torch.randn(a.shape, device=a.device,
                     generator=torch.Generator(device=a.device).manual_seed(
                         a.shape[1]))
    n0 = dict(rglru_scan_bwd.launches_by_path)
    got = rglru_scan_bwd(a, h, dh, h0, with_dh0=True)
    ran = [p for p, n in rglru_scan_bwd.launches_by_path.items()
           if n != n0[p]]
    want = ref.rglru_scan_bwd_ref(a, h, dh, h0)
    torch.cuda.synchronize()
    check(ran == [path(*a.shape)], f"{what}: ran {ran}, path says "
          f"{path(*a.shape)}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0, f"{what}: max_abs_err {err}, not the serial loop")
    out = {"path": ran[0], "max_abs_err": err}
    if timed:
        n = a.numel()
        extra = 0 if h0 is None else 2 * h0.numel() * 4
        out["bound_ms"], out["bound_by"] = bound(5 * n * 4 + extra, 3 * n)
        out["ms"] = time_ms(lambda: rglru_scan_bwd(a, h, dh, h0))
        out["device_ms"] = time_ms(lambda: rglru_scan_bwd(a, h, dh, h0),
                                   queued=True)
        out["plain_ms"] = time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, dh,
                                                                 h0), reps=3)
        out["library_ms"] = None
    return out


def ssd_bwd_bound(bsz: int, heads: int, groups: int, s: int, p: int,
                  n: int, dtype, with_h0: bool, with_dh: bool,
                  with_dh0: bool):
    """x, dy and dx, the grouped B, C, dB and dC in the inputs' type; dA,
    dt, ddA, ddt, and h0, dh and dh0 (each when the call reads or writes
    it) in f32, each read or written once; operations at the kernels' chunk of 64: per row pair
    the causal mask keeps within a chunk, 6N (C B^T, R B, R^T C) and 4P
    (dy x^T, W^T dy), per row 10NP (the chunk's two state terms, h_in^T
    dy, g^T x, g B), at the tensor-core rate for the inputs' type."""
    import torch
    from repro_torch.kernels.ssd_scan import CHUNK
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (esize * (3 * bsz * heads * s * p + 4 * bsz * groups * s * n)
              + 4 * 4 * bsz * heads * s
              + 4 * bsz * heads * p * n * (with_h0 + with_dh + with_dh0))
    pairs = sum(c * (c + 1) // 2 for c in
                (min(CHUNK, s - c0) for c0 in range(0, s, CHUNK)))
    ops = bsz * heads * (pairs * (6 * n + 4 * p) + 10 * s * n * p)
    return bound(nbytes, ops, matmul_peak(dtype))


def simt_ssd_bwd(args, dy, dh, with_dh0: bool = True):
    """The first SSD backward (csrc/ssd_scan_bwd.cu, the CUDA cores)
    called directly, so that it can be held and timed at shapes where the
    wrapper takes the tensor-core path; not counted in the wrapper's
    launches.  Returns what ``ssd_scan_bwd`` returns."""
    import torch
    from repro_torch.kernels import _build
    x, dA, dt, Bm, Cm, h0 = args
    bsz, heads, s, p = x.shape
    groups, n = Bm.shape[1], Bm.shape[3]
    lib = _build.load("ssd_scan_bwd")
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddA, ddt = torch.empty_like(dA), torch.empty_like(dt)
    dh0 = (torch.empty((bsz, heads, p, n), dtype=torch.float32,
                       device=x.device) if with_dh0 else None)
    buf = torch.empty(lib.ssd_scan_bwd_scratch_bytes(bsz, heads, s, p, n),
                      dtype=torch.uint8, device=x.device)
    opt = lambda t: None if t is None else t.data_ptr()
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dA.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), opt(h0), dy.data_ptr(), opt(dh), dx.data_ptr(),
        ddA.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        opt(dh0), buf.data_ptr(), bsz, heads, groups, s, p, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "ssd_scan_bwd (simt, direct)")
    return dx, ddA, ddt, dB, dC, dh0


def hold_ssd_bwd(args, dy, dh, timed: bool, twice: bool = False):
    """ssd_scan_bwd against its plain version (``ref.ssd_scan_bwd_ref`` at
    the kernels' chunk) on the forward's inputs `args`, dy and dh (None:
    zeros): each of dx, ddA, ddt, dB, dC and dh0 finite and within
    SSD_TOL of its largest |value|, one launch a call, on the path that
    ``bwd_path`` names; where that is the tensor-core kernel, the first
    design (``simt_ssd_bwd``) held beside it on the same inputs.  With
    `twice`, a second call bitwise equal to the first.  With `timed`, the
    kernel, its plain version and the first design (where it is not the
    path) timed, and the bound (no PyTorch call computes the same
    function).  Returns a dict."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import CHUNK, bwd_path, ssd_scan_bwd
    x, Bm, h0 = args[0], args[3], args[5]
    bsz, heads, s, p = x.shape
    groups, n = Bm.shape[1], Bm.shape[3]
    dt_name = str(x.dtype).split(".")[-1]
    what = (f"ssd_scan_bwd B={bsz} H={heads} G={groups} S={s} P={p} N={n} "
            f"{dt_name} h0={h0 is not None} dh={dh is not None}")
    n0 = ssd_scan_bwd.launches
    by0 = dict(ssd_scan_bwd.launches_by_path)
    got = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
    want = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk=CHUNK)
    torch.cuda.synchronize()
    check(ssd_scan_bwd.launches == n0 + 1,
          f"{what}: {ssd_scan_bwd.launches - n0} launches")
    ran = [k for k, c in ssd_scan_bwd.launches_by_path.items() if c != by0[k]]
    want_path = bwd_path(x.dtype, p, n)
    check(ran == [want_path], f"{what}: ran {ran}, bwd_path says {want_path}")
    tol = SSD_TOL[dt_name]

    def held(grads, label):
        errors = {}
        for name, g, w in zip(SSD_GRADS, grads, want):
            g, w = g.float(), w.float()
            check(bool(torch.isfinite(g).all()),
                  f"{what} ({label}): {name} not finite")
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            errors[name] = (err, err / max(scale, 1e-30))
            check(err <= tol * scale, f"{what} ({label}): {name} max_abs_err "
                  f"{err} of {scale} (limit {tol} of it)")
        return errors

    out = {"errors": held(got, ran[0]), "path": ran[0]}
    out["max_abs_err"] = max(e for e, _ in out["errors"].values())
    if ran[0] != "simt":
        out["simt_errors"] = held(simt_ssd_bwd(args, dy, dh), "simt")
        out["simt_max_abs_err"] = max(
            e for e, _ in out["simt_errors"].values())
    if twice:
        again = ssd_scan_bwd(*args, dy, dh, with_dh0=True)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        out["bitwise_twice"] = same
        check(same, f"{what}: two calls differ")
    if timed:
        # the timed calls ask for no dh0, as training's do without h0
        out["ms"] = time_ms(lambda: ssd_scan_bwd(*args, dy, dh))
        out["device_ms"] = time_ms(lambda: ssd_scan_bwd(*args, dy, dh),
                                   queued=True)
        if ran[0] != "simt":
            out["simt_ms"] = time_ms(
                lambda: simt_ssd_bwd(args, dy, dh, with_dh0=False))
            out["simt_device_ms"] = time_ms(
                lambda: simt_ssd_bwd(args, dy, dh, with_dh0=False),
                queued=True)
            check(out["device_ms"] < out["simt_device_ms"],
                  f"{what}: the tensor-core kernel {out['device_ms']:.4f} "
                  f"ms device, not below the first design's "
                  f"{out['simt_device_ms']:.4f} ms")
        out["plain_ms"] = time_ms(lambda: ref.ssd_scan_bwd_ref(
            *args, dy, dh, chunk=CHUNK), reps=5)
        out["library_ms"] = None
        out["bound_ms"], out["bound_by"] = ssd_bwd_bound(
            bsz, heads, groups, s, p, n, x.dtype, h0 is not None,
            dh is not None, with_dh0=False)
    return out


def flash_bwd_line(what: str, m: dict, phase: str = "phase8") -> str:
    """phase 8 (a)'s (or `phase`'s) line for one hold_flash_bwd
    measurement `m`."""
    def errs(errors):
        return "; ".join(f"{n} {e:.3g} ({w:.3g} of the allowance)"
                         for n, (e, w) in errors.items())

    line = f"{phase} flash_attention_bwd {what} path={m['path']}: " + errs(
        m["errors"])
    if "lse_err" in m:
        line += (f"; forward lse max_abs_err {m['lse_err']:.3g} (limit "
                 f"{LSE_TOL})")
    if "bitwise_twice" in m:
        line += f"; two calls bitwise equal {m['bitwise_twice']}"
    if "simt_errors" in m:
        line += f"; [first kernel: {errs(m['simt_errors'])}]"
    if "ms" in m:
        line += f"; kernel {m['ms']:.4f} ms (device {m['device_ms']:.4f} ms)"
        if "simt_ms" in m:
            line += (f" [first kernel {m['simt_ms']:.4f} ms, device "
                     f"{m['simt_device_ms']:.4f} ms]")
        line += (f", plain {m['plain_ms']:.4f} ms, "
                 f"{m.get('library', 'sdpa')} backward "
                 f"{m['library_ms']:.4f} ms (device "
                 f"{m['library_device_ms']:.4f} ms; forward and backward "
                 f"{m['library_both_ms']:.4f}), bound {m['bound_ms']:.5f} ms "
                 f"({m['bound_by']}), pairs {m['pairs']} a head")
    return line


def phase8_bwd_kernels():
    """(a) The three backward kernels against their plain versions at the
    serving shapes; returns the measurements for the kernels line."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    serve = {}
    cases = [(dtype, s, {}) for dtype in (torch.bfloat16, torch.float32)
             for s in SERVE_PROMPTS]
    cases += [(torch.bfloat16, 1000, {"softcap": 50.0})]
    for dtype, s, extra in cases:
        kw = dict(causal=True, kind="local", window=2048, **extra)
        scale = 8.0 if extra else 1.0
        q = randn(10, s, 256, dtype=dtype) * scale
        k = randn(1, s, 256, dtype=dtype) * scale
        v = randn(1, s, 256, dtype=dtype)
        m = hold_flash_bwd(q, k, v, kw, timed=not extra,
                           twice=s == max(SERVE_PROMPTS))
        dt = str(dtype).split(".")[-1]
        print(flash_bwd_line(
            f"BH=10 G=10 S={s} D=256 local 2048"
            f"{' softcap 50' if extra else ''} {dt}", m))
        if "ms" in m and m["path"] != "simt":
            check(m["ms"] <= m["library_ms"],
                  f"phase 8 (a): flash_attention_bwd S={s} {dt} "
                  f"{m['ms']:.4f} ms, slower than sdpa's backward "
                  f"{m['library_ms']:.4f} ms")
        if s == max(SERVE_PROMPTS) and not extra:
            key = ("flash_attention_bwd" if dtype == torch.bfloat16
                   else "flash_attention_bwd f32")
            serve[key] = dict(m, shape=[10, s, 256])
    serve.update(phase8_mla_bwd(randn))
    serve.update(phase8_train_lm_bwd(randn))
    for (bsz, s, w), with_h0 in (((1, 3000, 2560), False),
                                 ((1, 3000, 2560), True),
                                 ((4, 1000, 2560), False),
                                 ((2, 1000, 2562), True)):
        a = torch.rand((bsz, s, w), generator=gen, device=dev) * 0.5 + 0.5
        m = hold_scan_bwd(a, randn(bsz, s, w),
                          randn(bsz, w) if with_h0 else None,
                          timed=w % 4 == 0)
        line = (f"phase8 rglru_scan_bwd ({bsz}, {s}, {w}) h0={with_h0} "
                f"path={m['path']}: max_abs_err {m['max_abs_err']}")
        if "ms" in m:
            line += (f", kernel {m['ms']:.4f} ms (device "
                     f"{m['device_ms']:.4f} ms), plain {m['plain_ms']:.4f} "
                     f"ms, bound {m['bound_ms']:.5f} ms ({m['bound_by']})")
        print(line)
        if (bsz, s, w, with_h0) == (1, 3000, 2560, False):
            serve["rglru_scan_bwd"] = dict(m, shape=[bsz, s, w])
    # the SSD scan's backward at mamba2-2.7b's shapes (80 heads of 64,
    # d_state 128, one group), with h0 and a gradient by the final state
    # (a chunked prefill's) and without (training's); then grouped B and C
    # and a shape off the served one
    ssd_cases = [(dtype, (1, 80, 1, s, 64, 128), with_h0)
                 for dtype in (torch.bfloat16, torch.float32)
                 for s in SSM_PROMPTS for with_h0 in (False, True)]
    ssd_cases += [(torch.bfloat16, (2, 8, 2, 1000, 64, 128), True),
                  (torch.bfloat16, (1, 6, 3, 1000, 64, 128), True),
                  (torch.float32, (1, 24, 3, 777, 40, 100), True)]
    for dtype, (bsz, heads, groups, s, p, n), with_h0 in ssd_cases:
        A = -torch.linspace(1.0, 16.0, heads, device=dev)
        dt = torch.nn.functional.softplus(randn(bsz, heads, s) - 2.0)
        args = (randn(bsz, heads, s, p, dtype=dtype), dt * A[None, :, None],
                dt, randn(bsz, groups, s, n, dtype=dtype),
                randn(bsz, groups, s, n, dtype=dtype),
                randn(bsz, heads, p, n) if with_h0 else None)
        served = (bsz, heads, groups, p, n) == (1, 80, 1, 64, 128)
        m = hold_ssd_bwd(args, randn(bsz, heads, s, p, dtype=dtype),
                         randn(bsz, heads, p, n) if with_h0 else None,
                         timed=served and not with_h0,
                         twice=s == max(SSM_PROMPTS) and not with_h0)
        dt_name = str(dtype).split(".")[-1]
        def errs(errors):
            return "; ".join(f"{name} {e:.3g} ({r:.3g} of its largest)"
                             for name, (e, r) in errors.items())

        line = (f"phase8 ssd_scan_bwd B={bsz} H={heads} G={groups} S={s} "
                f"P={p} N={n} {dt_name} h0, dh={with_h0} path={m['path']}: "
                + errs(m["errors"]))
        if "bitwise_twice" in m:
            line += f"; two calls bitwise equal {m['bitwise_twice']}"
        if "simt_errors" in m:
            line += f"; [first design: {errs(m['simt_errors'])}]"
        if "ms" in m:
            line += (f"; kernel {m['ms']:.4f} ms (device "
                     f"{m['device_ms']:.4f} ms)")
            if "simt_ms" in m:
                line += (f" [first design {m['simt_ms']:.4f} ms, device "
                         f"{m['simt_device_ms']:.4f} ms: "
                         f"{m['simt_device_ms'] / m['device_ms']:.2f}x]")
            line += (f", plain {m['plain_ms']:.4f} ms, bound "
                     f"{m['bound_ms']:.5f} ms ({m['bound_by']}, "
                     f"{m['bound_ms'] / m['device_ms']:.3f} of the kernel's "
                     "device time)")
        print(line)
        if (s, served, with_h0) == (max(SSM_PROMPTS), True, False):
            key = ("ssd_scan_bwd" if dtype == torch.bfloat16
                   else "ssd_scan_bwd f32")
            serve[key] = dict(m, shape=[bsz, heads, s, p, n])
    return serve


def phase8_train_lm_bwd(randn) -> dict:
    """(a) flash_attention_bwd at the ~100M training example's shape (BH
    64 over 32 kv rows, S 512, D 96, causal, local 512, softcap 50, f32)
    on the 3xTF32 backward: within BWD_TOL of the plain backward, two
    calls bitwise equal, timed beside the first kernel, the plain version,
    one compiled flex_attention call's backward and the bound."""
    bh, g, s, d = TRAIN_LM_ATTN
    q, k, v = randn(bh, s, d), randn(bh // g, s, d), randn(bh // g, s, d)
    m = hold_flash_bwd(q, k, v, TRAIN_LM_KW, timed=True, twice=True)
    check(m["path"] == "tf32", f"flash_attention_bwd at the training "
          f"example's shape: path {m['path']}")
    print(flash_bwd_line(f"train_lm BH={bh} G={g} S={s} D={d} local 512 "
                         "softcap 50 float32", m))
    return {"flash_attention_bwd train_lm": dict(m, shape=[bh, s, d])}


def phase8_mla_bwd(randn) -> dict:
    """(a) flash_attention_bwd at deepseek-v2-236b's MLA shape: 128 heads
    (BH 128, group 1), q and k of head dim 192, v of 128, causal global,
    S = 512, 1,000, 2,048, 3,000; bf16 on the wgmma backward, f32 on the
    3xTF32 one (both reading the forward's lse; the first kernel held and
    timed beside each).  Each gradient within BWD_TOL of the plain
    version, two calls at S = 3,000 bitwise equal, timed beside the plain
    version and sdpa's backward, and the bound (6 D + 4 Dv = 1,664
    operations a kept pair); at S = 3,000 the f32 kernel's device time at
    most sdpa's backward's.  Returns the S = 3,000 measurements of both
    dtypes."""
    import torch
    bh, d, dv = MLA_HEADS, MLA_QK_DIM, MLA_V_DIM
    kw = dict(causal=True, kind="global")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        want = "wgmma" if dtype == torch.bfloat16 else "tf32"
        for s in SERVE_PROMPTS:
            q, k = randn(bh, s, d, dtype=dtype), randn(bh, s, d, dtype=dtype)
            v = randn(bh, s, dv, dtype=dtype)
            m = hold_flash_bwd(q, k, v, kw, timed=True,
                               twice=s == max(SERVE_PROMPTS))
            del q, k, v
            check(m["path"] == want, f"phase 8 (a) MLA S={s} {dt}: path "
                  f"{m['path']}, expected {want}")
            print(flash_bwd_line(f"MLA BH={bh} G=1 S={s} D={d} Dv={dv} "
                                 f"causal global {dt}", m))
            if dtype == torch.float32 and s == max(SERVE_PROMPTS):
                check(m["device_ms"] <= m["library_device_ms"],
                      f"phase 8 (a) MLA S={s} {dt}: device "
                      f"{m['device_ms']:.4f} ms against sdpa's backward "
                      f"{m['library_device_ms']:.4f} ms")
            if s == max(SERVE_PROMPTS):
                key = "flash_attention_bwd mla" + (
                    "" if dtype == torch.bfloat16 else " f32")
                out[key] = dict(m, shape=[bh, s, d, dv])
    return out


#: phase 8 (a): the AdamW kernels held at full-width leaves, as (label,
#: shape, weight and gradient dtype, moment dtype): recurrentgemma-2b's
#: embedding table in f32 state, and deepseek-v2-236b's stacked experts'
#: gate projection (one MoE layer's 160 experts, 1.26e9 elements) in bf16
#: weights, gradients and moments, both decayed, as the train step
#: updates them
ADAMW_LEAVES = (("recurrentgemma-2b embed/table", (256_000, 2_560),
                 "float32", "float32"),
                ("deepseek-v2-236b moe/w_gate", (160, 5_120, 1_536),
                 "bfloat16", "bfloat16"))
#: the gradient norm kernel against a float64 norm, relative: f32 partial
#: sums of 8,192 squares, added in f64
NORM_TOL = 1e-6
#: timed calls of each update (a plain one at deepseek-v2-236b's expert
#: leaf takes some 93 ms)
ADAMW_REPS = 10


def adamw_bound(n: int, p_size: int, g_size: int, m_size: int,
                h_size: int = 0):
    """The update's bound: p, m and v read and written, g read once, a
    held copy of `h_size` bytes an element written; 17 f32 operations an
    element (with the decay)."""
    return bound(n * (2 * p_size + g_size + 4 * m_size + h_size), 17 * n)


def phase8_adamw_kernels() -> dict:
    """(a) the AdamW update and gradient norm kernels at ADAMW_LEAVES, a
    clipped third step (scale 0.37, lr 3e-4, the bias corrections of step
    3) from random weights, gradients and moments: the update bitwise its
    plain version (``plain_update``, sliced as the plain step slices it)
    in p, m and v, two calls bitwise equal; the norm within NORM_TOL of
    the float64 norm and two calls bitwise equal.  An f32 leaf is updated
    as the train step updates it, with its bf16 held copy written in the
    same launch (bitwise the new weights' cast and the plain version's);
    the launch without the copy is timed beside it (``nohold_ms``), the
    difference the held store's time.  Each timed (``ms``
    and ``device_ms``) beside its plain version, its bound and one
    library call computing the same function up to rounding:
    ``torch._fused_adamw_`` on the same leaf with the gradient
    pre-scaled (it decays p by (1 - lr wd) first and adds eps to
    sqrt(v) / sqrt(b2c), so it is a yardstick, never on the path), and
    ``torch.linalg.vector_norm``.  Returns the measurements by kernel
    and leaf."""
    import gc
    import torch
    from repro_torch.kernels import _scratch
    from repro_torch.kernels.adamw import adamw_update, grad_norm
    from repro_torch.optim.adamw import AdamWConfig, plain_update
    power = card()
    _scratch.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = AdamWConfig()
    step = 3
    sc = [torch.tensor(x, dtype=torch.float32, device="cuda")
          for x in (0.37, 3e-4, 1 - cfg.b1 ** step, 1 - cfg.b2 ** step)]
    out = {}
    for label, shape, wdt, mdt in ADAMW_LEAVES:
        wdt, mdt = getattr(torch, wdt), getattr(torch, mdt)
        gen = torch.Generator(device="cuda").manual_seed(35)
        rand = lambda scale, dt: (torch.randn(shape, generator=gen,
                                              device="cuda") * scale).to(dt)
        p, g = rand(0.02, wdt), rand(1.0, wdt)
        m = rand(0.01, mdt)
        v = torch.square(rand(0.01, torch.float32)).to(mdt)
        n = p.numel()
        # f32 weights carry the train step's bf16 working copy
        copy = (lambda: torch.empty(shape, dtype=torch.bfloat16,
                                    device="cuda")) if wdt == torch.float32 \
            else (lambda: None)
        held = copy()
        # the plain version, then the kernel twice, from the same state
        plain = [t.clone() for t in (p, m, v)] + [copy()]
        plain_update(plain[0], g, plain[1], plain[2], cfg, *sc, True,
                     plain[3])
        runs = []
        for _ in range(2):
            k = [t.clone() for t in (p, m, v)] + [copy()]
            path = adamw_update(k[0], g, k[1], k[2], cfg, *sc, True, k[3])
            runs.append(k)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(runs[0], plain) if a is not None]
        if held is not None:
            pairs.append((runs[0][3], runs[0][0].to(torch.bfloat16)))
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
        twice = all(torch.equal(a, b) for a, b in zip(*runs)
                    if a is not None)
        del plain, runs, k, pairs
        norms = [grad_norm([g]), grad_norm([g])]
        want = float(torch.linalg.vector_norm(g.double()))
        norm_err = abs(float(norms[0]) - want) / want
        norm_twice = torch.equal(*norms)
        gc.collect()
        torch.cuda.empty_cache()

        def kernel():
            adamw_update(p, g, m, v, cfg, *sc, True, held)

        def plain_call():
            plain_update(p, g, m, v, cfg, *sc, True, held)

        gs = (g.float() * sc[0]).to(wdt)
        steps = [torch.tensor(float(step), device="cuda")]

        def library():
            torch._fused_adamw_([p], [gs], [m], [v], [], steps, lr=3e-4,
                                beta1=cfg.b1, beta2=cfg.b2,
                                weight_decay=cfg.weight_decay, eps=cfg.eps,
                                amsgrad=False, maximize=False)

        ms, plain_ms = time_pair_ms(kernel, plain_call, ADAMW_REPS)
        device_ms, plain_device_ms = time_pair_ms(kernel, plain_call,
                                                  ADAMW_REPS, queued=True)
        lib_ms = time_ms(library, ADAMW_REPS)
        lib_device_ms = time_ms(library, ADAMW_REPS, queued=True)
        del gs
        b_ms, b_by = adamw_bound(n, p.element_size(), g.element_size(),
                                 m.element_size(), 2 if held is not None
                                 else 0)
        upd = {"path": path, "shape": list(shape), "weights": str(wdt)[6:],
               "moments": str(mdt)[6:], "held": held is not None,
               "max_abs_err": err, "ms": ms,
               "device_ms": device_ms, "plain_ms": plain_ms,
               "plain_device_ms": plain_device_ms, "library": "_fused_adamw_",
               "library_ms": lib_ms, "library_device_ms": lib_device_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        store = ""
        if held is not None:
            def no_copy():
                adamw_update(p, g, m, v, cfg, *sc, True)
            upd["nohold_ms"], upd["nohold_device_ms"] = time_ms(
                no_copy, ADAMW_REPS), time_ms(no_copy, ADAMW_REPS,
                                              queued=True)
            store = (f" with the bf16 held copy written (without it "
                     f"{upd['nohold_ms']:.4f} ms, device "
                     f"{upd['nohold_device_ms']:.4f} ms: the held store "
                     f"{device_ms - upd['nohold_device_ms']:.4f} ms of "
                     "device time)")
        print(f"phase8 adamw_update {label} {tuple(shape)} {str(wdt)[6:]} "
              f"weights and gradients, {str(mdt)[6:]} moments, path "
              f"{path}: bitwise the plain version {bitwise} (max abs err "
              f"{err:.3g}), two calls bitwise {twice}; kernel {ms:.4f} ms "
              f"(device {device_ms:.4f} ms){store}, plain {plain_ms:.4f} ms "
              f"(device {plain_device_ms:.4f} ms), _fused_adamw_ "
              f"{lib_ms:.4f} ms (device {lib_device_ms:.4f} ms), bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / device_ms:.3f} of it; "
              f"{power}")
        check(bitwise and twice, f"phase 8 (a) adamw_update {label}: "
              f"bitwise {bitwise}, twice {twice}, max abs err {err}")

        def norm_plain():
            from repro_torch.optim.adamw import global_norm
            global_norm([g])

        nm, nm_plain = time_pair_ms(lambda: grad_norm([g]), norm_plain)
        nd, nd_plain = time_pair_ms(lambda: grad_norm([g]), norm_plain,
                                    queued=True)
        vec = lambda: torch.linalg.vector_norm(g, dtype=torch.float32)
        nl, nl_d = time_ms(vec), time_ms(vec, queued=True)
        nb_ms, nb_by = bound(n * g.element_size(), 2 * n)
        out[label] = upd, {
            "shape": list(shape), "dtype": str(wdt)[6:],
            "max_abs_err": norm_err * want, "max_rel_err": norm_err,
            "ms": nm, "device_ms": nd,
            "plain_ms": nm_plain, "plain_device_ms": nd_plain,
            "library": "torch.linalg.vector_norm", "library_ms": nl,
            "library_device_ms": nl_d, "bound_ms": nb_ms, "bound_by": nb_by}
        print(f"phase8 grad_norm {label} {tuple(shape)} {str(wdt)[6:]}: "
              f"{float(norms[0])!r} against float64 {want!r}, relative "
              f"error {norm_err:.3g} (limit {NORM_TOL}), two calls bitwise "
              f"{norm_twice}; kernels {nm:.4f} ms (device {nd:.4f} ms), "
              f"plain {nm_plain:.4f} ms (device {nd_plain:.4f} ms), "
              f"vector_norm {nl:.4f} ms (device {nl_d:.4f} ms), bound "
              f"{nb_ms:.4f} ms ({nb_by}), {nb_ms / nd:.3f} of it")
        check(norm_err <= NORM_TOL and norm_twice,
              f"phase 8 (a) grad_norm {label}: relative error {norm_err}, "
              f"twice {norm_twice}")
        del p, g, m, v, norms, held
        _scratch.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_counts() -> dict:
    """The forward and backward launch counts of the train steps'
    kernels, the SSD scan's forward and backward also by path, and the
    AdamW update's and gradient norm's."""
    from repro_torch.kernels.adamw import adamw_update, grad_norm
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    lm = lm_counts()
    counts = {"flash_attention": flash_attention.launches,
              "flash_attention.wgmma": lm["flash_attention.wgmma"],
              "flash_attention_bwd": flash_attention_bwd.launches,
              "rglru_scan": rglru_scan.launches,
              "rglru_scan_bwd": rglru_scan_bwd.launches}
    for fn in (ssd_scan, ssd_scan_bwd):
        counts[fn.__name__] = fn.launches
        counts.update({f"{fn.__name__}.{p}": c
                       for p, c in fn.launches_by_path.items()})
    counts.update(adamw_update=adamw_update.launches,
                  grad_norm=grad_norm.launches)
    return counts


def ssd_kernel(cfg) -> str:
    """The SSD scan's path for `cfg`'s compute dtype and SSD shape (the
    path its SSM layers' scans and their backwards take): "wgmma" where
    the model has no SSM layer."""
    import torch
    from repro_torch.kernels.ssd_scan import path
    if "ssm" not in cfg.layer_kinds():
        return "wgmma"
    return path(getattr(torch, cfg.dtype), cfg.ssd.head_dim,
                cfg.ssd.d_state)


def update_launches(params, steps: int) -> dict:
    """The AdamW kernels' launches in `steps` train steps of `params`:
    the update once a leaf that holds an element, the norm once."""
    n = sum(1 for t in _leaves(params) if t.numel())
    return {"adamw_update": n * steps, "grad_norm": steps}


#: the elementwise host ops whose device time a profiled train step
#: prints beside the AdamW kernels': what the eager update launched, and
#: what stays outside the kernels
ELEMENTWISE_OPS = ("aten::copy_", "aten::mul", "aten::mul_", "aten::add",
                   "aten::add_", "aten::div", "aten::div_", "aten::sub",
                   "aten::sub_", "aten::sqrt", "aten::square", "aten::pow",
                   "aten::clamp", "aten::fill_", "aten::sum")


def profile_train_step(bundle, state, batch, phase: str = "phase8"):
    """One train step under torch.profiler: wall time, device busy and
    idle share, the largest device entries, the largest host entries by
    their own host time, the AdamW kernels' device time beside the
    elementwise ops' that remain (ELEMENTWISE_OPS), and the backward
    kernels' device time, each by launch.  Returns (the state, {"wall_ms",
    "busy_ms", "idle"}); prints "not measured" without device time, and
    returns None in place of the times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _m = bundle.fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy <= 0:
        print(f"{phase} profile train step: device time not measured")
        return state, None
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    host = [e for e in rows if e.device_type == DeviceType.CPU]
    print(f"{phase} profile train step (profiled {wall * 1e3:.1f} ms): "
          f"device busy {busy * 1e3:.2f} ms, idle share "
          f"{1 - busy / wall:.4f}; {sum(e.count for e in host)} host op "
          "calls")
    print(f"{phase} profile   device: " + "; ".join(
        f"{e.key[:48]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
        for e in top))
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"{phase} profile   host: host time "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms in "
          f"{len(host)} op kinds; " + "; ".join(
              f"{e.key[:32]} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms"
              for e in top_host))
    ops = sorted((e for e in host if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:8]
    print(f"{phase} profile   device time by op: " + "; ".join(
        f"{e.key[:28]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
        for e in ops))
    for key in ("attn_bwd", "rglru_bwd", "flash", "rglru_tma", "ssd_state",
                "ssd_walk", "ssd_out", "ssd_bwd", "gemm"):
        mine = [e for e in dev if key in e.key.lower()]
        if mine:
            print(f"{phase} profile   {key}: " + "; ".join(
                f"{e.key[:40]} x{e.count}" for e in mine) + ", device "
                f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} "
                "ms")
    # a replay launches its kernels with no host op: PyTorch's elementwise
    # kernels (casts, copies, pointwise math) by their names
    elem = [e for e in dev if "elementwise_kernel" in e.key]
    elem_ms = sum(e.self_device_time_total for e in elem) / 1e3
    print(f"{phase} profile   elementwise kernels x"
          f"{sum(e.count for e in elem)} {elem_ms:.2f} ms of "
          f"{busy * 1e3:.2f} ms device busy")
    # the AdamW kernels' device time, and the elementwise work that stays
    # outside them (the weights' casts to the compute dtype, the loss),
    # by the host op that launched it (an eager step's)
    upd = [e for e in dev if "adamw_kernel" in e.key]
    nrm = [e for e in dev if "sumsq_" in e.key]
    rest = sorted((e for e in host if e.key in ELEMENTWISE_OPS
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    print(f"{phase} profile   AdamW update kernel x"
          f"{sum(e.count for e in upd)} "
          f"{sum(e.self_device_time_total for e in upd) / 1e3:.2f} ms, "
          f"gradient norm kernels x{sum(e.count for e in nrm)} "
          f"{sum(e.self_device_time_total for e in nrm) / 1e3:.2f} ms; "
          f"elementwise remainder "
          f"{sum(e.self_device_time_total for e in rest) / 1e3:.2f} ms: "
          + "; ".join(f"{e.key} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.2f} ms"
                      for e in rest))
    # the backward kernels' device time by launch: the attention
    # backward's four (D_i, dK/dV, dQ, the shares' sum) and the SSD
    # backward's three on the wgmma path (the chunk walks, the chunks'
    # gradients by head tile, the tiles' sum)
    ssd = [e for e in dev if re.search(r"\bssd_[a-z0-9_]+_kernel", e.key)]
    if ssd:
        ssd_ms = sum(e.self_device_time_total for e in ssd) / 1e3
        print(f"{phase} profile   SSD kernels, forward and backward: "
              f"{ssd_ms:.2f} ms of {busy * 1e3:.2f} ms device busy "
              f"({ssd_ms / (busy * 1e3):.4f}), the rest "
              f"{busy * 1e3 - ssd_ms:.2f} ms")
    for label, pattern in (("attention backward", r"attn_bwd_[a-z0-9_]+"),
                           ("ssd backward", r"ssd_bwd_[a-z0-9_]+")):
        bwd = sorted((e for e in dev if re.search(pattern, e.key)),
                     key=lambda e: -e.self_device_time_total)
        if bwd:
            total = sum(e.self_device_time_total for e in bwd) / 1e3
            print(f"{phase} profile   {label} by launch ({total:.3f} ms): "
                  + "; ".join(
                      f"{re.search(pattern, e.key).group(0)} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.self_device_time_total / 1e3 / e.count:.4f} ms "
                      "each)" for e in bwd))
    return state, {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
                   "idle": 1 - busy / wall, "elementwise_ms": elem_ms}


#: the profiler's names of the floating dtypes an ``aten::copy_`` moves
_PROF_DTYPES = {"float": "f32", "c10::BFloat16": "bf16", "c10::Half": "f16"}


def copy_split(fn, state, batch, cfg, phase: str, what: str):
    """One eager train step, ``fn(state, batch)`` (a ``graph=False``
    step), under torch.profiler with ``record_shapes``: the device time
    of every ``aten::copy_`` it launched, split by what it copies (its
    destination's and source's dtypes and its shape): "weight casts" (f32
    to bf16 or f16 at the shape of an f32 parameter and of no other),
    "gradient casts" (the other casts at a parameter's shape: gradients
    cast back to their parameter's dtype, and at bf16 state the f32 reads
    of bf16 weights), "logits" (the loss's bf16 logits widened to f32,
    vocabulary last), "layout" (a copy within one dtype), "other".
    Prints each share's count and device ms beside the step's busy time
    and its elementwise ops (ELEMENTWISE_OPS) by launching op.  Returns
    (the state, {share: (count, device ms)}, busy ms); the times None
    where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f32 = {tuple(t.shape) for t in _leaves(state["params"])
           if t.dtype == torch.float32}
    other = {tuple(t.shape) for t in _leaves(state["params"])
             if t.dtype != torch.float32}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        state, _m = fn(state, batch)
        torch.cuda.synchronize()
    split = {k: [0, 0.0] for k in ("weight casts", "gradient casts",
                                   "logits", "layout", "other")}
    # the inputs' dtypes by op id (a FunctionEvent's id is its kineto
    # event's correlation id; older releases give FunctionEvent no dtypes)
    dtypes = {ev.correlation_id(): ev.dtypes()
              for ev in prof.profiler.kineto_results.events()
              if ev.name() == "aten::copy_"}
    for e in prof.events():
        if e.name != "aten::copy_":
            continue
        dt = [_PROF_DTYPES.get(d) for d in dtypes.get(e.id, [])[:2]]
        shape = tuple((e.input_shapes or [()])[0])
        if len(dt) < 2 or None in dt:
            key = "other"
        elif dt[0] == dt[1]:
            key = "layout"
        elif dt[1] == "f32" and shape in f32 - other:
            key = "weight casts"
        elif shape in f32 | other:
            key = "gradient casts"
        elif dt[0] == "f32" and shape and shape[-1] == cfg.vocab_size:
            key = "logits"
        else:
            key = "other"
        split[key][0] += 1
        split[key][1] += e.self_device_time_total / 1e3
    rows = prof.key_averages()
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.key in ELEMENTWISE_OPS
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    total = sum(ms for _, ms in split.values())
    print(f"{phase} copy split, {what}: device busy {busy:.2f} ms; "
          f"aten::copy_ {total:.2f} ms: " + "; ".join(
              f"{k} x{c} {ms:.2f} ms" for k, (c, ms) in split.items())
          + "; elementwise by op: " + "; ".join(
              f"{e.key} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
              for e in ops) + f"; {card()}")
    if busy <= 0:
        print(f"{phase} copy split, {what}: device time not measured")
        return state, {k: (c, None) for k, (c, _) in split.items()}, None
    return state, {k: tuple(v) for k, v in split.items()}, busy


def cast_traffic(cfg, params) -> dict:
    """What casting `params`' f32 weights at use costs a train step of
    `cfg` at TRAIN_SEQ under remat, by the code: the leaves that get a
    held copy (``models.model.held_copies``' rule), each cast once a use,
    a layer of the body's periods twice (the forward and the
    recomputation), the head's and tail's and the frontend's once, the
    unembedding table twice a loss chunk; 6 bytes an element cast (f32
    read, bf16 written) and 2 a held element stored.  Shapes only:
    `params` may be fake tensors."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.models.steps import _pick_chunk
    from repro_torch.optim.adamw import leaves_with_path
    head, period, n_periods, _ = model_lib.block_structure(cfg)
    body = range(len(head), len(head) + len(period) * n_periods)
    s = TRAIN_SEQ - (cfg.n_frontend_tokens if cfg.frontend == "vision"
                     else 0)
    chunks = s // _pick_chunk(s)
    held = casts = 0
    for path, w in leaves_with_path(params):
        name = path[-1].strip("[]'")
        if (w.dtype != torch.float32 or name in model_lib.F32_READ
                or (path == ("['embed']", "['table']")
                    and "lm_head" in params)):
            continue
        if path[0] == "['layers']":
            uses = 2 if int(path[1].strip("[]")) in body else 1
        else:
            uses = 2 * chunks if name == "table" else 1
        held += w.numel()
        casts += w.numel() * uses
    return {"held": held, "casts": casts, "chunks": chunks,
            "cast_ms": 6 * casts / HBM_BYTES_PER_S * 1e3,
            "store_ms": 2 * held / HBM_BYTES_PER_S * 1e3}


def attribute_copies(archs=(TRAIN_ARCH, "gemma2-2b", SSM_ARCH)):
    """The ``aten::copy_`` split (``copy_split``) of one eager step of
    each of `archs` at phase 8 (b)'s shape and state, after one warm-up
    step, through ``make_train_step(..., graph=False)`` with its
    defaults.  Run alone after ``phase0_build``."""
    import gc
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state, put_batch
    out = {}
    for arch in archs:
        cfg, param_dtype, shape, opt_cfg = _train_setup(arch, TRAIN_STEPS)
        state = build_state(cfg, opt_cfg, seed=0, device="cuda",
                            param_dtype=param_dtype)
        fn = make_train_step(cfg, None, shape, opt_cfg, remat=True,
                             device="cuda", graph=False).fn
        pipe = TokenPipeline(cfg, shape, seed=0)
        state, _m = fn(state, put_batch(pipe.batch(0), "cuda"))
        state, out[arch], _busy = copy_split(
            fn, state, put_batch(pipe.batch(1), "cuda"), cfg, "phase8",
            f"{arch} eager step")
        del state, fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _layer_counts(cfg) -> tuple:
    """(layers by kind, forwards by kind under remat): "attention" (local,
    global or chunked), "recurrent", "ssm".  Remat runs each period of
    the body forward a second time in the backward; the head (deepseek's
    dense first layer) and tail layers run forward once."""
    from repro_torch.models.model import block_structure

    def count(kinds):
        return {"attention": sum(kinds.count(k) for k in
                                 ("local", "global", "chunked")),
                "recurrent": kinds.count("recurrent"),
                "ssm": kinds.count("ssm")}

    kinds = list(cfg.layer_kinds())
    head, period, n_periods, _ = block_structure(cfg)
    n = count(kinds)
    body = count(kinds[len(head):len(head) + n_periods * len(period)])
    return n, {k: n[k] + body[k] for k in n}, n_periods


def _train_config(arch: str, n_layers: int = 0):
    """(config, parameter dtype, moment dtype) of `arch` as TRAIN_TABLE
    trains it: its published width, its depth cut to `n_layers` where
    given, else to the table's; in bf16 state the router stays f32."""
    import torch
    from repro_torch.configs import get_config
    depth, dtype, _ = TRAIN_TABLE.get(arch, Trained())
    cfg = get_config(arch)
    if n_layers or depth:
        cfg = cfg.replace(n_layers=n_layers or depth)
    if arch == MOE_ARCH:
        m, moe = cfg.mla, cfg.moe
        check((cfg.d_model, cfg.n_heads, m.q_lora_rank, m.kv_lora_rank,
               m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim,
               moe.n_experts, moe.top_k, moe.d_ff_expert,
               moe.n_shared_experts, cfg.vocab_size)
              == (5120, MLA_HEADS, 1536, 512, MLA_QK_DIM, MLA_V_DIM, 160, 6,
                  1536, 2, 102400),
              f"phase 8: {MOE_ARCH} is not at its published width")
    return cfg, getattr(torch, dtype), dtype


def _train_setup(arch: str, steps: int, f32: bool = False):
    """(config, parameter dtype, input shape, AdamWConfig) of `arch`
    trained for `steps` steps at B TRAIN_BATCH, S TRAIN_SEQ: the AdamW
    settings the reference's ``train_loop`` builds for that many steps
    (warmup 1) at TRAIN_TABLE's learning rate, the moments in the state's
    dtype; with `f32`, computed in f32."""
    from repro_torch.configs import InputShape
    from repro_torch.optim import AdamWConfig
    cfg, param_dtype, moment_dtype = _train_config(arch)
    if f32:
        cfg = cfg.replace(dtype="float32")
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    return cfg, param_dtype, shape, AdamWConfig(
        lr=TRAIN_TABLE.get(arch, Trained()).lr, total_steps=steps,
        warmup_steps=1, moment_dtype=moment_dtype)


def step_counts() -> dict:
    """``train_counts`` and the attention backward's launches by path, as
    "flash_attention_bwd.<path>"."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    return dict(train_counts(), **{
        f"flash_attention_bwd.{p}": c
        for p, c in flash_attention_bwd.launches_by_path.items()})


class CaptureCounts:
    """A run's kernel launches through the captured train step
    (``distributed.steps.TrainStep``).  A captured step's wrappers count
    their launches once, when the capture records them, and its replays
    count none.  Around a block of steps this takes ``counts()`` at the
    start and as each capture (``distributed.steps.capture``) begins and
    ends: a capture's warm-up step launched what was counted between the
    capture before it (or the start) and its begin, the captured step
    what was counted inside it, and each of its replays that again."""

    def __init__(self, counts=step_counts):
        self.counts, self.marks = counts, []

    def __enter__(self):
        import repro_torch.distributed.steps as steps_mod
        self.mod, self.orig = steps_mod, steps_mod.capture
        self.start = self.counts()

        def capture(*args, **kw):
            begin = self.counts()
            out = self.orig(*args, **kw)
            self.marks.append((begin, self.counts()))
            return out
        steps_mod.capture = capture
        return self

    def __exit__(self, *exc):
        self.mod.capture = self.orig
        self.end = self.counts()

    def per_capture(self) -> list:
        """[(the warm-up step's launches, the captured step's)], one pair
        a capture."""
        out, last = [], self.start
        for begin, end in self.marks:
            out.append(({k: begin[k] - last[k] for k in begin},
                        {k: end[k] - begin[k] for k in end}))
            last = end
        return out

    def launched(self, replays) -> dict:
        """The launches the block ran: each capture's warm-up step's, and
        its captured step's times its replays (`replays`, a count a
        capture).  Nothing may be counted after the last capture, where
        only replays ran."""
        last = self.marks[-1][1] if self.marks else self.start
        check(self.end == last, f"launches counted after the last "
              f"capture (an eager step): {self.end} against {last}")
        total = {k: 0 for k in self.start}
        for (warm, captured), r in zip(self.per_capture(), replays):
            for k in total:
                total[k] += warm[k] + captured[k] * r
        return total


def state_checksums(state) -> list:
    """Each leaf of a train state's parameters and moments and its step
    count as the int64 sum of its elements' bit patterns: two runs whose
    lists are equal agree in every leaf's sum, which one element
    differing by any bit changes.  The held bf16 copies are left out
    (``held_fresh`` holds them to their parameters)."""
    import torch
    from repro_torch.optim.adamw import leaves_with_path
    ints = {4: torch.int32, 2: torch.int16}
    return torch.stack([
        t.detach().view(ints[t.element_size()]).sum(dtype=torch.int64)
        for _, t in leaves_with_path([state["params"], state["opt"]])
    ]).tolist()


def held_fresh(state) -> tuple:
    """(the count of the state's held bf16 copies, whether each is
    bitwise its parameter's ``.to(torch.bfloat16)``)."""
    import torch
    from repro_torch.optim.adamw import keystr, leaves_with_path
    held = state.get("held", {})
    fresh = all(torch.equal(held[keystr(path)], p.detach().to(
        torch.bfloat16)) for path, p in leaves_with_path(state["params"])
        if keystr(path) in held)
    return len(held), fresh


#: eager steps run on a graphed run's state after it for their time, where
#: no eager run from the seed holds the graphed one (the first warms the
#: eager step up, the last is timed)
EAGER_TIMED_STEPS = 2


def train_full_width(arch: str, label: str = "phase 8 (b)",
                     steps: int = TRAIN_STEPS, profile: bool = True,
                     f32: bool = False, hold: bool = False):
    """Phase 8 (b), phase 12 (a)-(f) and phase 14 (c): `arch` at its
    published width as TRAIN_TABLE trains it (recurrentgemma-2b and
    mamba2-2.7b at their depth with f32 master weights and moments,
    deepseek-v2-236b cut to MOE_TRAIN_LAYERS, the dense first layer and
    one MoE layer, with bf16 weights, gradients and moments; phase 12's
    six likewise); bf16 compute, remat on, B 1, S 3,000, TokenPipeline
    seed 0, `steps` steps through ``launch/train.py``'s ``build_state``
    and ``put_batch`` and ``make_train_step``'s captured step (a warm-up
    step and the capture, then `steps` - 1 replays), no checkpoint.
    Every loss finite, the last below the first, the peak within
    TRAIN_PEAK_GIB, the kernels' launches exact (``CaptureCounts``: the
    warm-up step's and the captured step's each one step's, so the run
    launched a step's `steps` times): each forward once a layer and
    again in each recomputed period, each backward once a layer, the
    attention forward and backward (deepseek: at MLA's q/k 192, v 128)
    and the SSD forward on their tensor-core paths.  The step holds bf16
    copies of the f32 weights it casts (``make_train_step``'s default
    ``held=True``; none at bf16 state or f32 compute), each bitwise its
    weight's cast at the end.  With `f32` (phase 14), computed in f32.
    With `profile`, one more graphed step under the profiler (the
    elementwise kernels' device time printed).  With `hold` (phase 8
    (b)), the same `steps` steps again from the seed through the eager
    step that casts at use (``graph=False, held=False``, the computation
    before held copies): every loss and gradient norm, and the final
    parameters' and moments' per-leaf checksums, bitwise the graphed
    run's, and one more of its steps split by ``copy_split``; without,
    EAGER_TIMED_STEPS eager steps of the held step on the trained state
    for their time.  One eager held step is split by ``copy_split``
    (the first of those, or one more on the trained state): it casts no
    weight (no f32 to bf16 copy at a parameter's shape).  Prints the
    step time graphed and eager, the capture's ms and pool bytes, the
    peak allocated and reserved.  Returns the launches in the run, the
    attention backward's by path among them as
    "flash_attention_bwd.<path>"."""
    import gc
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state, put_batch
    from repro_torch.kernels import _scratch
    phase = label.split(" (")[0].replace(" ", "")
    # the kernels' scratch and the models of earlier phases would count in
    # this model's peak: drop them, so that the peak holds only what this
    # model asks for
    _scratch.clear()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg, param_dtype, shape, opt_cfg = _train_setup(arch, steps, f32)
    n, fwd, n_periods = _layer_counts(cfg)
    t0 = time.perf_counter()
    state = build_state(cfg, opt_cfg, seed=0, device="cuda",
                        param_dtype=param_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in _leaves(
        [state["params"], state["opt"].m, state["opt"].v])) / 1e9
    print(f"{phase} {arch}: {n_params:,} parameters, "
          f"{str(param_dtype)[6:]} weights (and gradients), "
          f"{opt_cfg.moment_dtype} moments: {state_gb:.2f} GB of weights "
          f"and moments, computed in {cfg.dtype}; {cfg.n_layers} layers ("
          + " + ".join(f"{c} {k}" for k, c in n.items() if c)
          + f"), B {TRAIN_BATCH}, S {TRAIN_SEQ}; state built in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
          f"({before / 2**30:.3f} before); {opt_cfg}")
    bundle = make_train_step(cfg, None, shape, opt_cfg, remat=True,
                             device="cuda")
    fn = bundle.fn
    pipe = TokenPipeline(cfg, shape, seed=0)
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    reset_lm_counts()

    def run(fn, state, first: int, count: int, what: str):
        losses, norms, times = [], [], []
        for i in range(first, first + count):
            batch = put_batch(pipe.batch(i), "cuda")
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(float(m["grad_norm"]))
            print(f"{phase} {arch} {what} step {i}: loss {loss:.4f}, "
                  f"grad_norm {norms[-1]:.4f}, lr {float(m['lr']):.3g}, "
                  f"{times[-1] * 1e3:.1f} ms")
        return state, losses, norms, times

    with CaptureCounts() as cc:
        state, losses, norms, times = run(fn, state, 0, steps, "graphed")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    # cudaMalloc calls that failed and were retried after the allocator
    # freed its cache (each a device-wide sync)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    check(fn.graphed and fn.captures == 1 and fn.replays == steps - 1,
          f"{label} {arch}: {fn.captures} captures and {fn.replays} "
          f"replays in {steps} steps")
    (warm, captured), = cc.per_capture()
    counts = cc.launched([fn.replays])
    T = steps
    ssd = ssd_kernel(cfg)
    one = {k: 0 for k in counts}
    one.update({"flash_attention": fwd["attention"],
                "flash_attention.wgmma": fwd["attention"],
                "flash_attention_bwd": n["attention"],
                "flash_attention_bwd.wgmma": n["attention"],
                "rglru_scan": fwd["recurrent"],
                "rglru_scan_bwd": n["recurrent"],
                "ssd_scan": fwd["ssm"], f"ssd_scan.{ssd}": fwd["ssm"],
                "ssd_scan_bwd": n["ssm"], f"ssd_scan_bwd.{ssd}": n["ssm"],
                **update_launches(state["params"], 1)})
    want = {k: c * T for k, c in one.items()}
    steady = statistics.median(times[1:])
    print(f"{phase} {arch} train launches: {counts}; expected {want} (the "
          f"forwards once a layer and again in each of the {n_periods} "
          f"recomputed periods; the AdamW update once a leaf a step, the "
          f"norm once; the attention backward on wgmma); counted at the "
          f"warm-up step {warm == one}, at the capture {captured == one}, "
          f"{fn.replays} replays")
    print(f"{phase} {arch} train: losses {[round(x, 4) for x in losses]}; "
          f"step time first (warm-up and capture) {times[0] * 1e3:.1f} ms, "
          f"median of the replays {steady * 1e3:.1f} ms = "
          f"{TRAIN_BATCH * TRAIN_SEQ / steady:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB allocated, {reserved / 2**30:.3f} GiB "
          f"reserved, {retries} allocations retried")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"{label} {arch}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{label} {arch}: the loss did not "
          f"fall: {losses}")
    check(peak <= TRAIN_PEAK_GIB * 2**30, f"{label} {arch}: peak memory "
          f"{peak / 2**30:.3f} GiB, more than {TRAIN_PEAK_GIB}")
    check(warm == captured == one, f"{label} {arch}: launches counted at "
          f"the warm-up step {warm} and at the capture {captured}, a "
          f"step's {one}")
    check(counts == want, f"{label} {arch}: launches {counts}, "
          f"expected {want}")
    sums = state_checksums(state) if hold else None
    n_held, fresh = held_fresh(state)
    held_gb = sum(t.numel() * 2 for t in state.get("held", {}).values()) / 1e9
    t = cast_traffic(cfg, state["params"])
    print(f"{phase} {arch} held copies: {n_held} leaves, {held_gb:.2f} GB "
          f"in bf16, each bitwise its weight's cast after {steps} steps "
          f"{fresh}; casting at use instead: {t['casts']:,} elements a step "
          f"({t['chunks']} loss chunks), {t['cast_ms']:.2f} ms at the HBM "
          f"rate, the held store {t['store_ms']:.2f} ms")
    check(fresh, f"{label} {arch}: a held copy is not its weight's cast")
    prof = None
    if profile:
        state, prof = profile_train_step(
            bundle, state, put_batch(pipe.batch(steps), "cuda"), phase)
    capture_ms, pool_bytes = fn.capture_ms, fn.pool_bytes
    # the graph and its pool go before the eager steps take as much again
    fn.close()
    del bundle, fn
    gc.collect()
    torch.cuda.empty_cache()
    eager = make_train_step(cfg, None, shape, opt_cfg, remat=True,
                            device="cuda", graph=False, held=not hold).fn
    # one eager step of the held step (in phase 12 and 14 the first of the
    # eager steps, which warms them up) split by what it copies
    split_step = make_train_step(cfg, None, shape, opt_cfg, remat=True,
                                 device="cuda", graph=False).fn \
        if hold else eager
    state, split, _ = copy_split(
        split_step, state, put_batch(pipe.batch(steps + 1), "cuda"), cfg,
        phase, f"{arch} eager step, {n_held} held copies")
    check(not n_held or split["weight casts"][0] == 0, f"{label} {arch}: "
          f"the held step cast {split['weight casts'][0]} weights")
    if hold:
        del state
        gc.collect()
        torch.cuda.empty_cache()
        state = build_state(cfg, opt_cfg, seed=0, device="cuda",
                            param_dtype=param_dtype)
        state, e_losses, e_norms, e_times = run(eager, state, 0, steps,
                                                "eager, casts at use")
        e_sums = state_checksums(state)
        same = (e_losses == losses, e_norms == norms, e_sums == sums)
        state, _split, _ = copy_split(
            eager, state, put_batch(pipe.batch(steps), "cuda"), cfg, phase,
            f"{arch} eager step casting at use")
        print(f"{phase} {arch} graphed held against eager casting at use "
              f"from the seed, "
              f"{steps} steps: losses {'bitwise' if same[0] else 'differ'}"
              f", gradient norms {'bitwise' if same[1] else 'differ'}, "
              f"{len(sums)} leaves' checksums "
              f"{'bitwise' if same[2] else 'differ'}")
        check(all(same), f"{label} {arch}: the graphed run is not the "
              f"eager one: losses {losses} against {e_losses}, norms "
              f"{norms} against {e_norms}, checksums differ in leaves "
              f"{[i for i, (a, b) in enumerate(zip(sums, e_sums)) if a != b]}")
        eager_ms = statistics.median(e_times[1:])
    else:
        state, _l, _n, e_times = run(eager, state, steps + 2,
                                     EAGER_TIMED_STEPS - 1, "eager")
        eager_ms = e_times[-1]
    del state, eager, split_step
    print(f"{phase} {arch} graph: step graphed {steady * 1e3:.1f} ms, "
          f"eager{' casting at use' if hold else ''} "
          f"{eager_ms * 1e3:.1f} ms ({eager_ms / steady:.2f}x), "
          f"capture {capture_ms:.1f} ms, pool {pool_bytes} bytes, peak "
          f"{peak / 2**30:.3f} GiB allocated ({reserved / 2**30:.3f} GiB "
          "reserved)" + (f"; profiled step busy {prof['busy_ms']:.2f} ms, "
                         f"idle share {prof['idle']:.4f}" if prof else "")
          + f"; {card()}")
    TRAIN_RUNS[arch + (" f32" if f32 else "")] = {
        "losses": losses, "counts": {k: counts[k] for k in train_counts()}}
    return counts


class RoutingReplay:
    """Wraps the MoE router (``models.moe._router``).  In its first run it
    records each call's routing (every token's experts and keep flags
    under the capacity); in the run after ``replay()`` each call routes
    by the first run's call of the same order (the weights recomputed
    from this run's own gates at those experts, so the gradient reaches
    the router as it does through the top-k), and records the routing
    its own gates would have chosen beside.  Both runs make the same
    calls in the same order: the MoE forward's and the aux loss's, then
    both again in remat's recomputation."""

    def __init__(self):
        import torch
        from repro_torch.models import moe as moe_mod
        self.moe, self.orig = moe_mod, moe_mod._router
        self.first, self.own = [], []
        self.replaying = False

        def router(params, x2d, moe):
            w, idx, gates = self.orig(params, x2d, moe)
            pos = moe_mod._positions_in_expert(idx, moe.n_experts)
            route = (idx, pos < moe_mod._capacity(idx.shape[0], moe))
            if not self.replaying:
                self.first.append(route)
                return w, idx, gates
            self.own.append(route)
            idx = self.first[len(self.own) - 1][0]
            w = gates.gather(1, idx)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
            return w, idx, gates

        moe_mod._router = router

    def replay(self):
        self.replaying = True

    def close(self):
        self.moe._router = self.orig


def first_layers(cfg, n: int):
    """`cfg` cut to its first `n` layers.  A depth that is not a whole
    number of periods (llama4-maverick's is 4 layers, the lcm of its
    pattern and its MoE interleave) runs them as the tail of a model with
    no period, which remat runs as they are."""
    import math
    kinds = cfg.layer_kinds()[:n]
    period = math.lcm(len(cfg.pattern), cfg.moe.moe_period if cfg.moe else 1)
    head = cfg.moe.first_dense_layers if cfg.moe else 0
    cut = (cfg.replace(n_layers=n) if (n - head) % period == 0
           else cfg.replace(n_layers=n, pattern_tail=kinds))
    check(cut.layer_kinds() == kinds, f"{cfg.name}: the first {n} layers "
          f"are {kinds}, the cut model's {cut.layer_kinds()}")
    return cut


def phase8_period_grads(arch: str, n_layers: int = 0, f32: bool = False,
                        witness: bool = False, phase: str = "phase8"):
    """(c) one period of `arch` at its published width (recurrentgemma:
    rec, rec, local; mamba2: one SSM layer), or deepseek-v2-236b's first
    `n_layers` layers (c1: the dense layer alone; c2: with one MoE layer;
    bf16 weights), or phase 11 (g)'s first layers of the architectures in
    GRAD_LAYERS (f32 weights), or phase 12 (h)'s first `n_layers` of
    gemma2-2b (its period, local then global, softcap 50; f32 weights),
    S 1,024, bf16 compute: every gradient
    leaf through the kernels against the plain versions, relative in norm
    within GRAD_TOL, with the kernels' launches exact, each attention
    kernel's by path.
    With `f32` (c3: deepseek's dense layer alone), f32 weights and
    compute, the attention forward and backward on their 3xTF32 paths at
    MLA's q/k 192, v 128, and every leaf and the loss within
    F32_GRAD_TOL.  A leaf whose gradient through the
    kernels is identically zero while the plain versions' is not fails,
    whatever its norm: the train step fills unused gradients with zeros,
    which hid the SSD scan's lost gradient until its backward kernel.
    With MoE layers, bf16 rounding flips near-tied experts between the
    two runs (as phase 6 (b) finds), and a token routed otherwise has
    another gradient: the plain run routes every token as the kernels'
    run did (RoutingReplay), so every leaf is held, and the routing its
    own gates would have chosen is printed against the kernels'.  With
    `witness`, the same gradients in f32 compute through the plain
    versions as well, and each bf16 run's error against that witness:
    what of the kernels' distance from the plain run is bf16 rounding,
    which the plain run shares."""
    import gc
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import put_batch
    from repro_torch.models import model as model_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim.adamw import leaves_with_path
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     path)
    gc.collect()
    torch.cuda.empty_cache()
    cfg, param_dtype, _ = _train_config(arch, n_layers)
    if arch == SSM_ARCH:
        cfg = cfg.replace(n_layers=1)
    elif arch == TRAIN_ARCH:
        cfg = cfg.replace(n_layers=3, pattern_tail=())
    elif arch in GRAD_LAYERS:
        # phase 11 (g): f32 weights, whatever TRAIN_TABLE trains them in
        cfg = first_layers(cfg, GRAD_LAYERS[arch])
        param_dtype = torch.float32
    if f32:
        cfg, param_dtype = cfg.replace(dtype="float32"), torch.float32
    tol = F32_GRAD_TOL if f32 else GRAD_TOL
    label = f"{arch} ({cfg.n_layers} layers)" if n_layers else arch
    label += " f32" if f32 else ""
    n, fwd, _ = _layer_counts(cfg)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    shape = InputShape("phase8c", PERIOD_SEQ, 1, "train")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
        param_dtype=param_dtype)
    named = leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    batch = put_batch(TokenPipeline(cfg, shape, seed=0).batch(0), "cuda")
    grads, losses = [], []

    def counts():
        """train_counts with each attention kernel's launches by path"""
        c = train_counts()
        for fn in (flash_attention, flash_attention_bwd):
            c.update({f"{fn.__name__}.{p}": k
                      for p, k in fn.launches_by_path.items()})
        return c

    # one backward a layer; the forwards once a layer and again in each
    # recomputed period; attention on the path of its dtype and head dims
    # (the tensor cores' at 64, 128, 256 and MLA's 192 / 128)
    qk = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim if cfg.mla
          else cfg.resolved_head_dim())
    attn = path(torch.float32 if f32 else torch.bfloat16, qk,
                cfg.attn_softcap, cfg.mla.v_head_dim if cfg.mla else qk)
    want_kernel = {k: 0 for k in counts()}
    want_kernel.update({"flash_attention": fwd["attention"],
                        f"flash_attention.{attn}": fwd["attention"],
                        "flash_attention_bwd": n["attention"],
                        f"flash_attention_bwd.{attn}": n["attention"],
                        "rglru_scan": fwd["recurrent"],
                        "rglru_scan_bwd": n["recurrent"],
                        "ssd_scan": fwd["ssm"],
                        f"ssd_scan.{ssd_kernel(cfg)}": fwd["ssm"],
                        "ssd_scan_bwd": n["ssm"],
                        f"ssd_scan_bwd.{ssd_kernel(cfg)}": n["ssm"]})
    routing = RoutingReplay() if n_moe else None
    kernel_launches = {}
    try:
        for use_kernel in (True, False):
            if routing is not None and not use_kernel:
                routing.replay()
            n0 = counts()
            loss, _ = steps_lib.loss_fn(cfg, params, batch, remat=True,
                                        use_kernel=use_kernel)
            grads.append(torch.autograd.grad(loss, leaves))
            losses.append(float(loss.detach()))
            d = {k: v - n0[k] for k, v in counts().items()}
            if use_kernel:
                kernel_launches = d
            print(f"{phase} {label} period grads use_kernel={use_kernel}: "
                  f"launches {d}")
            want = want_kernel if use_kernel else {k: 0 for k in d}
            check(d == want, f"{phase} {label} use_kernel={use_kernel}:"
                  f" launches {d}, expected {want}")
    finally:
        if routing is not None:
            routing.close()
    if routing is not None:
        # the MoE forward's and the aux loss's calls, again in each
        # recomputed period
        _, period, n_periods, _ = model_lib.block_structure(cfg)
        calls = 2 * (n_moe + n_periods * sum(s.is_moe for s in period))
        check(len(routing.first) == len(routing.own) == calls,
              f"{phase} {label}: router calls {len(routing.first)}, "
              f"{len(routing.own)}, expected {calls} each")
        diffs = [_routing_diff(a, b) for a, b in zip(routing.first,
                                                     routing.own)]
        print(f"{phase} {label} routing: the plain run's own gates against "
              f"the kernels' routing, by router call (MoE forward, aux "
              f"loss, then both recomputed; {PERIOD_SEQ} tokens, top-"
              f"{cfg.moe.top_k} of {cfg.moe.n_experts}): tokens whose "
              f"experts differ {[x[0] for x in diffs]}, assignments whose "
              f"keep flag differs {[x[1] for x in diffs]}; the plain run "
              f"routed as the kernels' run did")
    if witness:
        loss, _ = steps_lib.loss_fn(cfg.replace(dtype="float32"), params,
                                    batch, remat=True, use_kernel=False)
        grads.append(torch.autograd.grad(loss, leaves))
    errs, lost = [], []
    for (path, _), gk, gp in zip(named, grads[0], grads[1]):
        name = "/".join(p.strip("[]'") for p in path)
        e = float((gk.float() - gp.float()).norm()
                  / gp.float().norm().clamp_min(1e-30))
        errs.append((name, e))
        if not bool(gk.any()) and bool(gp.any()):
            lost.append(name)
    worst = max(e for _, e in errs)
    n_params = sum(p.numel() for p in leaves)
    print(f"{phase} {label} period grads ({cfg.n_layers} layers of width "
          f"{cfg.d_model}, {n_params:,} parameters, {str(param_dtype)[6:]} "
          f"weights, S {PERIOD_SEQ}, {cfg.dtype} compute): loss kernels "
          f"{losses[0]:.7f}, plain {losses[1]:.7f}; each leaf's relative "
          f"error in norm (limit {tol}): "
          + "; ".join(f"{n} {e:.2e}" for n, e in errs))
    if witness:
        def rel(g, w):
            return float((g.float() - w.float()).norm()
                         / w.float().norm().clamp_min(1e-30))

        wit = [(name, rel(gk, gw), rel(gp, gw)) for (name, _), gk, gp, gw
               in zip(errs, *grads)]
        at = max(range(len(errs)), key=lambda i: errs[i][1])
        print(f"{phase} {label} period grads against an f32 witness (f32 "
              f"compute, plain versions): kernels' worst leaf "
              f"{max(w[1] for w in wit):.3e}, plain run's "
              f"{max(w[2] for w in wit):.3e}; the leaf farthest between "
              f"kernels and plain, {wit[at][0]} ({errs[at][1]:.3e}): "
              f"kernels {wit[at][1]:.3e}, plain {wit[at][2]:.3e} from the "
              f"witness; " + "; ".join(f"{n} {k:.2e} / {p:.2e}"
                                        for n, k, p in wit))
    print(f"{phase} {label} period grads: worst leaf {worst:.3e}; leaves "
          f"zero through the kernels but not through the plain versions: "
          f"{lost or 'none'}")
    check(not lost, f"{phase} {label}: gradients lost through the "
          f"kernels: {lost}")
    check(worst <= tol, f"{phase} {label}: a gradient leaf "
          f"differs by {worst} in norm")
    check(abs(losses[0] - losses[1]) <= tol * abs(losses[1]),
          f"{phase} {label}: losses {losses}")
    if arch == SSM_ARCH:
        scan_only = [(n, gk) for (n, _), gk in zip(errs, grads[0])
                     if n.endswith("A_log") or n.endswith("dt_bias")]
        check(len(scan_only) == 2 * cfg.n_layers
              and all(bool(g.any()) for _, g in scan_only),
              f"{phase}: A_log and dt_bias gradients "
              f"{[(n, float(g.abs().max())) for n, g in scan_only]}")
    return kernel_launches


def phase8_drill():
    """(d) the fail/resume drill on the card at the smoke config: train
    10 steps, fail at 6, resume from the step-4 checkpoint and finish;
    then the straight 8-step run against a resumed one, steps 4-7 within
    rtol 1e-4."""
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.distributed import InjectedFailure
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig
    cfg = get_smoke_config(TRAIN_ARCH)
    shape = InputShape("t", 64, 2, "train")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ckpt"
        try:
            train_loop(cfg, shape, steps=10, ckpt_dir=ckpt, save_every=4,
                       fail_at=6, quiet=True, device="cuda")
            check(False, "phase 8 (d): the injected failure did not fire")
        except InjectedFailure:
            pass
        check(latest_step(ckpt) == 4, f"phase 8 (d): latest step "
              f"{latest_step(ckpt)} after the failure")
        _s, history = train_loop(cfg, shape, steps=10, ckpt_dir=ckpt,
                                 resume=True, save_every=4, quiet=True,
                                 device="cuda")
        check(len(history) == 6 and np.isfinite(history[-1])
              and latest_step(ckpt) == 10,
              f"phase 8 (d): resumed {len(history)} steps, latest "
              f"{latest_step(ckpt)}")
        oc = AdamWConfig(total_steps=8, warmup_steps=1)
        _s, straight = train_loop(cfg, shape, steps=8, quiet=True,
                                  opt_cfg=oc, device="cuda")
        ckpt2 = f"{tmp}/ckpt2"
        train_loop(cfg, shape, steps=4, ckpt_dir=ckpt2, save_every=4,
                   quiet=True, opt_cfg=oc, device="cuda")
        _s, resumed = train_loop(cfg, shape, steps=8, ckpt_dir=ckpt2,
                                 resume=True, quiet=True, opt_cfg=oc,
                                 device="cuda")
    worst = float(np.max(np.abs(np.array(straight[4:]) - np.array(resumed))
                         / np.abs(np.array(resumed))))
    print(f"phase8 drill: failed at step 6, resumed from 4, finished at "
          f"10 (losses {[round(x, 4) for x in history]}); straight "
          f"{[round(x, 5) for x in straight[4:]]} against resumed "
          f"{[round(x, 5) for x in resumed]}: worst relative difference "
          f"{worst:.3g} (limit 1e-4); {time.perf_counter() - t0:.2f} s")
    check(worst <= 1e-4, f"phase 8 (d): resumed losses differ by {worst}")


def phase8_policy_fit():
    """(e) the policy fit on the card against the same fit on the CPU:
    each step's loss within 1e-4, and every train and holdout decision
    the same on both, save where the card's pick and the CPU's are a
    tie on the CPU fit: their scores there within TIE_TOL of each other
    (relative to the larger), so rounding decides.  At most MAX_TIE_FLIPS
    such decisions a split may differ.  The fixture's 13 train decisions
    hold one such pair, 2.4e-7 apart, which the CPU fit breaks one way
    and any change of summation order (the card's, or the init moved by
    1e-7) the other, 1/13 of the agreement.  The raw agreements are
    printed beside.  The card's fit updates through the AdamW kernels,
    once a leaf a step, the norm once a step; the CPU's launches
    neither.  Returns the card fit's launches."""
    import numpy as np
    import torch
    import repro_torch.policy.train as train_mod
    from repro_torch.kernels.adamw import adamw_update, grad_norm
    from repro_torch.policy import (TrainConfig, load_traces, matrices,
                                    np_scores, split, train_policy)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 8 (e): TF32 matmuls are on; the fit needs full f32")
    tr, ho = split(load_traces(str(ROOT / POLICY_TRACES)))
    cfg = TrainConfig(hidden=16, epochs=30, seed=0)
    C = max(tr.max_candidates, ho.max_candidates, 1)
    orig_step = train_mod._step
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        losses = []

        def recording(*args):
            res = orig_step(*args)
            losses.append(float(res[1]))
            return res

        train_mod._step = recording
        n0 = adamw_update.launches, grad_norm.launches
        try:
            t0 = time.perf_counter()
            policy, m = train_policy(tr, ho, cfg, device=device)
            out[device] = (policy, m, time.perf_counter() - t0, losses)
        finally:
            train_mod._step = orig_step
        launches[device] = {"adamw_update": adamw_update.launches - n0[0],
                            "grad_norm": grad_norm.launches - n0[1]}
    (pc, mc, tc, lc), (ph, mh, th, lh) = out["cuda"], out["cpu"]
    want = {"adamw_update": len(lc) * len(train_mod.TRAINABLE_KEYS),
            "grad_norm": len(lc)}
    print(f"phase8 policy fit AdamW kernel launches: card {launches['cuda']}"
          f", expected {want}; CPU {launches['cpu']}")
    check(launches == {"cuda": want, "cpu": {k: 0 for k in want}},
          f"phase 8 (e): AdamW kernel launches {launches}, expected {want} "
          "on the card and none on the CPU")
    worst = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    print(f"phase8 policy fit ({len(tr)} train, {len(ho)} holdout "
          f"decisions, {cfg}): card {tc:.3f} s, CPU {th:.3f} s, "
          f"{len(lc)} steps each, worst step loss difference {worst:.3g} "
          f"(limit 1e-4), final loss {mc['loss']:.6f} against "
          f"{mh['loss']:.6f}")
    check(len(lc) == len(lh) and worst <= 1e-4,
          f"phase 8 (e): step losses differ by {worst}")
    for name, ds in (("train", tr), ("holdout", ho)):
        X, mask, y = matrices(ds, n_candidates=C)
        sc = np_scores(pc, X) - 1e9 * (1.0 - mask)
        sh = np_scores(ph, X) - 1e9 * (1.0 - mask)
        rows = np.arange(len(y))
        pick_c, pick_h = sc.argmax(-1), sh.argmax(-1)
        # the CPU fit's scores of the two picks: a tie if within TIE_TOL
        hi, lo = sh[rows, pick_h], sh[rows, pick_c]
        gap = (hi - lo) / np.maximum(1.0, np.abs(hi))
        differ = pick_c != pick_h
        flips = differ & (gap <= TIE_TOL)
        print(f"phase8 policy fit {name}: raw agreement card "
              f"{mc[name + '_agreement']:.4f}, CPU "
              f"{mh[name + '_agreement']:.4f}; {int(differ.sum())} of "
              f"{len(y)} decisions differ, {int(flips.sum())} of them ties "
              f"on the CPU fit (gaps {gap[differ].tolist()}, tolerance "
              f"{TIE_TOL}); the rest the same")
        check(not (differ & ~flips).any() and flips.sum() <= MAX_TIE_FLIPS,
              f"phase 8 (e): {name} decisions {rows[differ].tolist()} "
              f"differ between the card and the CPU, relative gaps "
              f"{gap[differ].tolist()} on the CPU fit")
    return launches["cuda"]


#: the losses and launch counts of each architecture's run in phase 8 (b)
#: or 12, which phase 10 (b) holds the mesh step to and phase 12 (g) the
#: train loop
TRAIN_RUNS: dict = {}


def phase8_training():
    """Phase 8's parts in order; returns (a)'s measurements (the AdamW
    kernels' under "adamw") and each architecture's launches in (b), the
    attention backward's by path among them, (c3)'s launches under "c3"
    and (e)'s AdamW launches under "policy_fit"."""
    t0 = time.perf_counter()
    serve = phase8_bwd_kernels()
    t_a = time.perf_counter()
    serve["adamw"] = phase8_adamw_kernels()
    print(f"phase8 (a) AdamW kernels held and timed in "
          f"{time.perf_counter() - t_a:.1f} s")
    counts = {arch: train_full_width(arch, hold=True)
              for arch in TRAIN_ARCHS + (MOE_ARCH,)}
    for arch in TRAIN_ARCHS:
        phase8_period_grads(arch)
    for n_layers in (1, MOE_TRAIN_LAYERS):
        phase8_period_grads(MOE_ARCH, n_layers)
    # (c3) deepseek's dense layer in f32: MLA's attention on the 3xTF32
    # kernels; its launches count for the f32 MLA kernels' entries
    counts["c3"] = phase8_period_grads(MOE_ARCH, 1, f32=True)
    phase8_drill()
    counts["policy_fit"] = phase8_policy_fit()
    print(f"phase8 total {time.perf_counter() - t0:.1f} s")
    return serve, counts


# ---------------------------------------------------------------------------
# phase 9: the serving entry points
# ---------------------------------------------------------------------------

#: phase 9 (b): gemma2-2b at its published width (26 layers, local
#: attention in a window of 4,096 alternating with global, 8 query heads
#: over 4 kv heads of 256, a softcap of 50 on the scores and 30 on the
#: logits); the 6,000-token prompts pass the window, so the local layers'
#: ring cache rolls
GEMMA_ARCH = "gemma2-2b"
GEMMA_PROMPTS = (512, 3000, 6000)
GEMMA_MAX_LEN = 8192
GEMMA_FLASH_S = (3000, 6000)
#: phase 9 (c): the serve_cluster twin at the example's defaults, its
#: engines as the example builds them (``serve_cluster.SLOTS``, ...)
CLUSTER_TICKS, CLUSTER_RELEASE_AFTER = 30, 6
#: the plain rerun of the twin's requests: one instance of this many slots
CLUSTER_PLAIN_SLOTS = 16
COLD_START_REPS = 5


def serve_outcome(res) -> dict:
    """Every outcome of a serve-driver run that does not read the wall
    clock."""
    s, c = res.sched, res.scaling
    return {"density": res.density,
            "qos_violation_rate": res.qos_violation_rate,
            "requests": res.requests,
            "violated_requests": res.violated_requests,
            "nodes_peak": res.nodes_peak,
            "sched": (s.decisions, s.fast, s.slow, s.failed,
                      s.instances_placed),
            "scaling": (c.real_cold_starts, c.logical_cold_starts,
                        c.releases, c.evictions, c.migrations)}


def _printed(fn, prefix: str):
    """Calls `fn`, prints what it printed with `prefix` before each line;
    returns its result and the lines."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"{prefix}{line}")
    return out, lines


def phase9a_serve_driver() -> int:
    """``repro_torch.launch.serve`` at its defaults (jiagu, dual-staged,
    600 s, seed 0) with the predictor on engine "cuda", then on "numpy"
    with the same seed (the oracle): every outcome equal, the forest
    kernel launched in the first run and not in the second.  Returns the
    first run's forest launches."""
    import torch
    from repro_torch.kernels.rfr_inference import (rfr_forest_apply,
                                                   reset_launches)
    from repro_torch.launch import serve
    runs = {}
    for engine in ("cuda", "numpy"):
        args = serve.parse_args(["--engine", engine])
        reset_launches()
        t0 = time.perf_counter()
        res = serve.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rfr_forest_apply.launches
        _printed(lambda: serve.report(args, res), f"phase9 (a) {engine} | ")
        print(f"phase9 (a) engine={engine}: {wall:.2f} s (dataset, forest "
              f"fit, {args.seconds} simulated s), forest kernel launches "
              f"{launches}, inference calls {res.inference_calls}, "
              f"mean_inference_ms {res.mean_inference_ms:.4f}")
        runs[engine] = (serve_outcome(res), launches)
    (got, launches), (want, numpy_launches) = runs["cuda"], runs["numpy"]
    diff = _differing(got, want)
    print(f"phase9 (a) cuda vs numpy: differing outcomes {diff or 'none'}")
    check(not diff, f"phase 9 (a): the serve driver on the card differs "
          f"from numpy in {diff}")
    check(launches > 0 and numpy_launches == 0,
          f"phase 9 (a): forest launches {launches} on the card, "
          f"{numpy_launches} on numpy")
    return launches


def phase9b_gemma2() -> dict:
    """gemma2-2b at its published width, served as phase 5 serves with
    caches of GEMMA_MAX_LEN: every prefill launches 26 flash kernels, all
    on the wgmma path with the softcap; the logits held in norm against
    the plain run and an f32 witness (``serve_full_width``'s
    `f32_witness`), every layer's flash output in the longest prompt's
    prefill against the plain version on its own q, k, v; then the flash
    kernel at its shapes timed against its plain version, its bound and
    one compiled flex_attention call (sdpa takes no tanh softcap).
    Returns the launches and the timings."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import path
    from repro_torch.models import model as model_lib
    _free_models("phase9 (b)")
    cfg = get_config(GEMMA_ARCH)
    kinds = cfg.layer_kinds()
    n_local, n_global = kinds.count("local"), kinds.count("global")
    check(cfg.n_layers == n_local + n_global == 26 and cfg.d_model == 2304
          and cfg.head_dim == 256 and cfg.attn_softcap == 50.0,
          f"phase 9 (b): {GEMMA_ARCH} is {cfg.n_layers} layers "
          f"({n_local} local, {n_global} global) of {cfg.d_model}")
    check(path(torch.bfloat16, cfg.head_dim, cfg.attn_softcap) == "wgmma",
          "phase 9 (b): gemma2's attention is not on the wgmma path")
    n = cfg.n_layers
    launches, _ = serve_full_width(
        "phase9", GEMMA_ARCH, GEMMA_PROMPTS, 9, flash_launches(n, "wgmma"),
        f"{n_local} local in a window of {cfg.window} + {n_global} global, "
        f"{cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, softcap {cfg.attn_softcap:g}",
        max_len=GEMMA_MAX_LEN, f32_witness=True)
    # each layer's flash output in a prefill past the window, against the
    # plain version on its own q, k, v
    _free_models("phase9 (b) layers")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, max(GEMMA_PROMPTS))),
        device=model_lib.params_device(params))
    stash = FlashStash()
    try:
        model_lib.prefill(cfg, params, {"tokens": toks}, GEMMA_MAX_LEN)
    finally:
        stash.close()
    check(len(stash.calls) == n, f"phase 9 (b): {len(stash.calls)} flash "
          f"calls in a prefill of {n} layers")
    worst = hold_stashed_flash(stash.calls, f"phase9 (b) "
                               f"{max(GEMMA_PROMPTS)}-token prefill")
    print(f"phase9 (b) the {n} layers' flash outputs: worst element "
          f"{worst:.3g} of the allowance")
    del params, stash
    _free_models("phase9 (b) flash")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    bh, bh_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    times = []
    for kind, window in (("local", cfg.window), ("global", 0)):
        for s in GEMMA_FLASH_S:
            # scores scaled by 16 so that the softcap bites
            q, k = randn(bh, s, d, scale=4.0), randn(bh_kv, s, d, scale=4.0)
            v = randn(bh_kv, s, d)
            kw = dict(causal=True, kind=kind, window=window,
                      softcap=cfg.attn_softcap)
            m = hold_flash(q, k, v, kw, with_library=True)
            check(m["path"] == "wgmma", f"phase 9 (b): flash at S={s} "
                  f"{kind} ran {m['path']}")
            print(f"phase9 flash_attention BH={bh} G={bh // bh_kv} S={s} "
                  f"D={d} {kind} {window} softcap {cfg.attn_softcap:g} "
                  f"bfloat16 path={m['path']}: max_abs_err "
                  f"{m['max_abs_err']:.3g} ({m['worst']:.3g} of the "
                  f"allowance), kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms), simt kernel "
                  f"{m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} "
                  f"ms), plain {m['plain_ms']:.4f} ms, {m['library']} "
                  f"{m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f} ms, max_abs_err "
                  f"{m['library_err']:.3g}, mask and compile "
                  f"{m['library_setup_s']:.1f} s), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}), pairs "
                  f"{m['pairs']}")
            times.append(dict(m, shape=[bh, bh_kv, s, d], kind=kind,
                              window=window, softcap=cfg.attn_softcap))
    return {"launches": launches, "times": times}


def hold_tokens(label: str, served, plain, rec_k, rec_p) -> str:
    """Each served request's tokens against the plain rerun's, step by
    step, from the two runs' ``ServeRecorder.by_rid``, while the two
    agree: the logits before the final softcap (which saturates random
    weights' logits and would hide what differs before it) within
    LOGIT_TOL in norm and within LOGIT_TOL of their largest |logit|
    (phase 5's limit); the same token wherever the plain run's top-2
    margin exceeds LOGIT_TOL of the largest |logit|, and the same argmax
    before the cap wherever the margin there exceeds LOGIT_TOL of its
    largest.  After a token that differs where the margin is within
    that, the two continue from other tokens and are not compared."""
    import torch
    by_rid = {r.rid: r for r in plain}
    worst = worst_cap = worst_abs = 0.0
    held = checked = pre_checked = parted = 0
    for r in served:
        p = by_rid[r.rid]
        lk, lp = rec_k.by_rid[r.rid], rec_p.by_rid[r.rid]
        check(len(lk) == len(lp) == len(r.tokens) == len(p.tokens),
              f"{label} request {r.rid}: {len(lk)} and {len(lp)} logits "
              f"rows for {len(r.tokens)} tokens")
        for i, ((a, a_pre), (b, b_pre)) in enumerate(zip(lk, lp)):
            capped = a_pre is not None
            a_pre, b_pre = (a_pre, b_pre) if capped else (a, b)
            check(bool(torch.isfinite(a).all())
                  and bool(torch.isfinite(a_pre).all()),
                  f"{label} request {r.rid} step {i}: logits not finite")
            err = float((a_pre - b_pre).norm() / b_pre.norm())
            err_abs = float((a_pre - b_pre).abs().max()
                            / b_pre.abs().max())
            check(err <= LOGIT_TOL and err_abs <= LOGIT_TOL,
                  f"{label} request {r.rid} step {i}: logits before the "
                  f"cap differ by {err} in norm, by {err_abs} of the "
                  "largest at most")
            worst = max(worst, err)
            worst_abs = max(worst_abs, err_abs)
            worst_cap = max(worst_cap, float((a - b).norm() / b.norm()))
            held += 1
            pairs = [(a, b, "token")]
            if capped:
                pairs.append((a_pre, b_pre, "argmax before the cap"))
            for x, y, what in pairs:
                top2 = torch.topk(y, 2).values
                margin = float(top2[0] - top2[1])
                if margin > LOGIT_TOL * float(y.abs().max()):
                    got, want = ((int(x.argmax()), int(y.argmax()))
                                 if what != "token" else
                                 (r.tokens[i], p.tokens[i]))
                    check(got == want, f"{label} request {r.rid} step {i}: "
                          f"{what} {got} against {want}, top-2 margin "
                          f"{margin}")
                    if what == "token":
                        checked += 1
                    else:
                        pre_checked += 1
            if r.tokens[i] != p.tokens[i]:
                parted += 1
                break
    return (f"{held} steps' logits held before the cap (worst {worst:.5f} "
            f"in norm, {worst_abs:.5f} of the largest |logit|; after it "
            f"{worst_cap:.5f} in norm), argmax before the cap "
            f"checked at {pre_checked}, tokens checked at {checked}, "
            f"{parted} requests parted at a margin within the tolerance")


def cold_starts(arch: str, eng):
    """Times COLD_START_REPS real cold starts of `eng` (``scale_up(1)``:
    a new instance and its slot cache) and as many logical ones (each
    after a ``release(1)``, ``logical_start(1)``), each synchronised, on
    the host clock; prints each, the median and the largest."""
    import statistics as st
    import torch
    real, logical = [], []
    for _ in range(COLD_START_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.scale_up(1)
        torch.cuda.synchronize()
        real.append(1e3 * (time.perf_counter() - t0))
    for _ in range(COLD_START_REPS):
        eng.release(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = eng.logical_start(1)
        torch.cuda.synchronize()
        logical.append(1e3 * (time.perf_counter() - t0))
        check(got == 1, f"phase 9 (c) {arch}: logical start revived {got}")

    def summary(ms):
        return (f"median {st.median(ms):.4f} ms, max {max(ms):.4f} ms "
                f"({', '.join(f'{x:.4f}' for x in ms)})")

    print(f"phase9 (c) {arch} cold start, host clock, synchronised, "
          f"{COLD_START_REPS} each, weights resident: real (scale_up(1), "
          f"slots {eng.slots}, max_len {eng.max_len}) {summary(real)}; "
          f"logical (logical_start(1)) {summary(logical)}")


def phase9c_cluster() -> dict:
    """The serve_cluster twin at published width: gemma2-2b and
    mamba2-2.7b on random f32 weights from a generator seeded 0, computed
    in each config's dtype, as the example builds its engines; its loop
    at the example's defaults under the sinusoid, then under burst-storm.
    Every prefill launches each model's kernels, all on the tensor-core
    paths; every served request's tokens are held against the same
    prompts through the plain versions, run eagerly.  Every instance
    decodes through its captured step, one replay a decode step; the
    instances that captured and their capture ms are printed, and at the
    twin's engines a captured step is held against an eager one
    (``hold_graph``).  Then one real cold start
    (``scale_up(1)``) and one logical start (``logical_start(1)``) of
    each, timed at the twin's engines and at phase 9 (b)'s serving
    configuration.  Returns each load's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_cluster
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import (Request, ServingEngine,
                                            ServingInstance)
    _free_models("phase9 (c)")
    cfgs = {a: get_config(a) for a in serve_cluster.ARCHS}
    params = {a: model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        for a, cfg in cfgs.items()}
    torch.cuda.synchronize()
    per_prefill = {}
    for a, cfg in cfgs.items():
        kinds = cfg.layer_kinds()
        n_attn = sum(kinds.count(k) for k in ("local", "global"))
        per_prefill[a] = {"flash_attention": n_attn,
                          "ssd_scan": kinds.count("ssm")}
        print(f"phase9 (c) {a}: {sum(t.numel() for t in _leaves(params[a])):,}"
              f" parameters (f32, computed in {cfg.dtype}), "
              f"{cfg.n_layers} layers, per prefill {per_prefill[a]}")
    print(f"phase9 (c) {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          "allocated")

    def engines(replicas=serve_cluster.REPLICAS):
        out = {}
        for a, cfg in cfgs.items():
            eng = ServingEngine(cfg, params[a], slots=serve_cluster.SLOTS,
                                max_len=serve_cluster.MAX_LEN)
            eng.scale_up(replicas)
            out[a] = eng
        return out

    # warm-up (the kernels' first launch), not counted
    warm = engines(replicas=1)
    for a, eng in warm.items():
        eng.submit(Request(-1, np.zeros(serve_cluster.PROMPT_LEN, np.int32),
                           2))
        eng.drain()
    del warm
    all_launches = {}
    kept = None
    captures = {a: [] for a in cfgs}
    for scenario in ("sinusoid", "burst-storm"):
        load = serve_cluster.offered_load(
            scenario, list(cfgs), CLUSTER_TICKS, seed=0)
        engs = engines()
        rec_k = ServeRecorder(steps=True)
        reset_lm_counts()
        try:
            t0 = time.perf_counter()
            stats, _ = _printed(lambda: serve_cluster.run(
                engs, CLUSTER_TICKS, CLUSTER_RELEASE_AFTER, load,
                np.random.default_rng(0)), f"phase9 (c) {scenario} | ")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rec_k.close()
        launches = lm_counts()
        served = {a: s["served"] for a, s in stats.items()}
        want = {}
        for name in ("flash_attention", "ssd_scan"):
            total = sum(per_prefill[a][name] * len(served[a])
                        for a in cfgs)
            want[name] = want[f"{name}.wgmma"] = total
            want[f"{name}.tf32"] = want[f"{name}.simt"] = 0
        got = {k: launches[k] for k in want}
        print(f"phase9 (c) {scenario}: {wall:.2f} s for {CLUSTER_TICKS} "
              f"ticks and the drain, served "
              f"{ {a: len(v) for a, v in served.items()} }; launches by "
              f"path {got}, expected {want}")
        check(got == want, f"phase 9 (c) {scenario}: launches {got} != "
              f"{want}")
        check(not launches["rglru_scan"], "phase 9 (c): an RG-LRU scan "
              "launched")
        for a, eng in engs.items():
            for inst in eng.instances.values():
                n_steps = rec_k.decode_steps[inst.iid]
                check(inst.decoder.replays == n_steps,
                      f"phase 9 (c) {scenario} {a} instance {inst.iid}: "
                      f"{inst.decoder.replays} replays for {n_steps} "
                      "decode steps")
                if inst.decoder.capture_ms is not None:
                    captures[a].append((inst.decoder.capture_ms,
                                        inst.decoder.pool_bytes))
            print(f"phase9 (c) {scenario} {a}: decode steps by instance "
                  f"{[rec_k.decode_steps[i] for i in sorted(eng.instances)]}"
                  f", each one replay of its captured step")
        for a, cfg in cfgs.items():
            eng = ServingEngine(cfg, params[a], slots=CLUSTER_PLAIN_SLOTS,
                                max_len=serve_cluster.MAX_LEN,
                                use_kernel=False, graph=False)
            eng.scale_up(1)
            for r in served[a]:
                eng.submit(Request(r.rid, r.prompt.copy(), r.max_new))
            rec_p = ServeRecorder(steps=True)
            reset_lm_counts()
            try:
                t0 = time.perf_counter()
                plain = eng.drain()
                torch.cuda.synchronize()
                wall_p = time.perf_counter() - t0
            finally:
                rec_p.close()
            check(not any(lm_counts().values()),
                  f"phase 9 (c): the plain rerun launched {lm_counts()}")
            check(sorted(r.rid for r in plain)
                  == sorted(r.rid for r in served[a]),
                  f"phase 9 (c) {scenario} {a}: the plain rerun served "
                  "other requests")
            print(f"phase9 (c) {scenario} {a} plain rerun ({wall_p:.2f} s, "
                  f"{CLUSTER_PLAIN_SLOTS} slots): "
                  + hold_tokens(f"phase 9 (c) {scenario} {a}", served[a],
                                plain, rec_k, rec_p))
        all_launches[scenario] = launches
        if kept is None:
            kept = engs
        else:
            del engs
    # the data plane's side of a cold start: a real one allocates an
    # instance's slot cache (the replicas share the weights, which stay
    # resident: loading them, part of a deployment's real start, is not
    # timed); a logical one re-labels a cached instance.  At the twin's
    # engines and at the serving configuration of phase 9 (b)
    for a, eng in kept.items():
        ms = [c for c, _ in captures[a]]
        print(f"phase9 (c) {a}: {len(ms)} instances captured their decode "
              f"step in the two loads (the rest served no request), "
              f"capture ms (warm-up + capture) "
              f"{', '.join(f'{x:.2f}' for x in ms)}; median "
              f"{statistics.median(ms):.2f} ms; the pool grew by "
              f"{', '.join(f'{b / 2**20:.1f}' for _, b in captures[a])} "
              "MiB at each (one pool for the function's graphs)")
        # the graph against eager at the twin's engines
        inst = ServingInstance(cfgs[a], params[a], slots=serve_cluster.SLOTS,
                               max_len=serve_cluster.MAX_LEN)
        rng = np.random.default_rng(93)
        for i in range(serve_cluster.SLOTS):
            inst.admit(Request(i, rng.integers(
                0, cfgs[a].vocab_size, serve_cluster.PROMPT_LEN).astype(
                    np.int32), SERVE_MAX_NEW))
        hold_graph(f"phase9 (c) {a} twin's engine", cfgs[a], params[a],
                   inst.decoder, inst.last_token, inst.pos)
        inst.close()
        del inst
        cold_starts(a, eng)
        big = ServingEngine(cfgs[a], params[a], slots=SERVE_SLOTS,
                            max_len=GEMMA_MAX_LEN)
        cold_starts(a, big)
        del big
    return all_launches


def phase9_serving_entry_points() -> tuple:
    """Phase 9's parts in order; returns (a)'s forest launches, (b)'s
    launches and flash timings, and (c)'s launches by load."""
    t0 = time.perf_counter()
    serve_launches = phase9a_serve_driver()
    gemma = phase9b_gemma2()
    cluster = phase9c_cluster()
    print(f"phase9 total {time.perf_counter() - t0:.1f} s")
    return serve_launches, gemma, cluster


# ---------------------------------------------------------------------------
# phase 10: the mesh steps on a 1x1 NCCL mesh, compression, the dry run
# ---------------------------------------------------------------------------

MESH_STEPS = 3
MESH_PROMPTS = (512, 3000)
MESH_NEW = 16
MESH_LOSS_RTOL = 1e-5
DRYRUN_ARCH, DRYRUN_SHAPE, DRYRUN_LIMIT_S = "qwen1.5-110b", "train_4k", 120
#: (e): the two MoE models the reference's ``moe_dshard`` decode schedule
#: is for, each traced at full config on the single-pod mesh with the
#: default hints and with moe_dshard, in one subprocess; (f): deepseek-v2
#: served on the 1x1 mesh under both, MESH_PROMPTS then DSHARD_NEW
#: greedy decode steps
DSHARD_ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
DSHARD_SHAPE, DSHARD_LIMIT_S, DSHARD_NEW = "decode_32k", 240, 8


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def warm_flex():
    """While phase 10 (e)'s dry runs finish on the host, compile the
    flex_attention yardstick of phases 4 and 8 at the ~100M training
    example's attention shape, forward and backward (set-up, untimed:
    the first compile in a process takes some 30 s), so that their timed
    phases find it compiled."""
    import torch
    bh, g, s, d = TRAIN_LM_ATTN
    q, k, v = (torch.randn((rows, s, d), device="cuda")
               for rows in (bh, bh // g, bh // g))
    t0 = time.perf_counter()
    flex_library_bwd(q, k, v, torch.randn_like(q), TRAIN_LM_KW)
    print(f"phase0 flex_attention compiled at the training example's "
          f"shape, forward and backward, in {time.perf_counter() - t0:.1f} s")


def start_dryruns() -> dict:
    """(e): one subprocess a job, all at once, on the host alone (no card
    visible to them), each printing its record as the last line of its
    output: ``launch.dryrun.run_cell`` of DRYRUN_ARCH x DRYRUN_SHAPE on a
    fake process group of each mesh kind; and in one more, of each of
    DSHARD_ARCHS x DSHARD_SHAPE on the single-pod mesh with the default
    hints and with ``moe_dshard`` (its records by arch and hints).
    Started beside phase 0's build and waited for before phase 1
    (``finish_dryruns``), so that they share the host with no timed
    phase."""
    head = ("import json, logging, sys, warnings; "
            "warnings.filterwarnings('ignore'); "
            "logging.disable(logging.WARNING); sys.path.insert(0, 'src'); "
            "from repro_torch.launch.dryrun import run_cell; ")
    tail = ("[x['collectives'].pop('_top', None) for x in recs]; "
            "print(json.dumps(r, default=str))")
    cell = (f"r = run_cell({DRYRUN_ARCH!r}, {DRYRUN_SHAPE!r}, sys.argv[1]); "
            "recs = [r]; ")
    twins = (f"r = {{a: {{o: run_cell(a, {DSHARD_SHAPE!r}, 'single', "
             "{o: 1} if o == 'moe_dshard' else {}) for o in ('default', "
             f"'moe_dshard')}} for a in {DSHARD_ARCHS!r}}}; "
             "recs = [x for t in r.values() for x in t.values()]; ")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = {kind: (cell, DRYRUN_LIMIT_S) for kind in ("single", "multi")}
    jobs["moe"] = (twins, DSHARD_LIMIT_S)
    return {job: (time.perf_counter(), limit, subprocess.Popen(
        [sys.executable, "-c", head + code + tail, job], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for job, (code, limit) in jobs.items()}


def finish_dryruns(procs: dict) -> dict:
    """(e) each dry-run subprocess's record within its limit of its start,
    with its wall time, by mesh kind and by MoE arch (that arch's two
    records by hints): status ok, or the run fails."""
    recs = {}
    for job, (t0, limit, proc) in procs.items():
        left = max(limit - (time.perf_counter() - t0), 1.0)
        try:
            out, err = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            check(False, f"phase 10 (e): the {job} dry run took more than "
                  f"{limit} s")
        wall = time.perf_counter() - t0
        lines = out.strip().splitlines()
        check(proc.returncode == 0 and lines, f"phase 10 (e): the {job} "
              f"dry run exited {proc.returncode}: {err[-2000:]}")
        rec = json.loads(lines[-1])
        by_job = {job: rec} if "status" in rec else rec
        for name, r in by_job.items():
            for one in ([r] if "status" in r else r.values()):
                check(one.get("status") == "ok", f"phase 10 (e): {name} dry "
                      f"run {one.get('status')}: {str(one)[:2000]}")
            recs[name] = (r, wall)
    return recs


def dshard_wire_delta(cfg, shape, data: int = 16, model: int = 16) -> tuple:
    """(all-gather, all-reduce) wire bytes that ``moe_dshard`` adds to a
    decode step of `cfg` at `shape` on a (data, model) mesh, by
    ``launch.roofline.TraceCounter``'s convention (a gather counts its
    gathered tensor, an all-reduce twice its tensor), a MoE layer each:
    the experts' FSDP gathers of w_gate, w_up and w_down (E_l, d, F) in
    f32 (the dry run's parameters) go; the routed rows (B, d) gathered
    over "data" and the output's d split laid out as rows again (a gather
    and a chunk on the dry run's CPU mesh) come; the gate and up
    products' partial sums (2, E_l, G C, F) in the compute dtype,
    all-reduced over "data", come.  G is one group a data shard, C the
    capacity of a group's B / G tokens."""
    m = cfg.moe
    B, d, F = shape.global_batch, cfg.d_model, m.d_ff_expert
    e_l, G = m.n_experts // model, data
    c = math.ceil(B // G * m.top_k / m.n_experts * m.capacity_factor)
    C = max(8, -(-c // 8) * 8)
    cb = 2 if cfg.dtype == "bfloat16" else 4
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    gathers = 3 * e_l * d * F * 4
    rows = 2 * B * d * cb
    partial = 2 * (2 * e_l * G * C * F * cb)
    return n_moe * (rows - gathers), n_moe * partial, {
        "moe_layers": n_moe, "experts_a_rank": e_l, "G": G, "C": C,
        "expert_gathers": n_moe * gathers, "rows": n_moe * rows,
        "partial_sums": n_moe * partial}


def _dryrun_line(label: str, rec: dict) -> str:
    r, c = rec["roofline"], rec["collectives"]
    gib = rec["memory"]["arg_bytes_analytic_per_device"] / 2**30
    kinds = ", ".join(f"{k} {c[k]:.6g}" for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"))
    return (f"phase10 (e) dryrun {label}: status {rec['status']}, "
            f"{r['n_devices']} devices, dispatch {rec.get('dispatch')}, "
            f"{gib:.3f} GiB of arguments a device; wire bytes a device "
            f"{kinds}; compute {r['compute_s']:.4g} s, memory "
            f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s "
            f"-> bottleneck {r['bottleneck']}; useful_ratio "
            f"{r['useful_ratio']:.4g}, roofline_frac {r['roofline_frac']:.4g};"
            f" traced in {rec['trace_s']} s")


def phase10e_dryruns(recs: dict, power: str) -> dict:
    """(e) each dry run's record (``finish_dryruns``) printed; for each of
    DSHARD_ARCHS, ``moe_dshard``'s argument bytes equal to the default
    hints' (the hint moves no parameter) and its all-gather and
    all-reduce wire bytes apart from theirs by exactly
    ``dshard_wire_delta``.  Returns the MoE records' wire bytes by kind
    and roofline terms."""
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    out = {}
    for job, (rec, wall) in recs.items():
        if job in ("single", "multi"):
            print(_dryrun_line(f"{DRYRUN_ARCH} x {DRYRUN_SHAPE} x {job}",
                               rec) + f", {wall:.1f} s with start-up, beside "
                  f"phase 0's build (host of the {power} machine; H100 SXM5 "
                  "constants)")
            continue
        for hint, r in rec.items():
            print(_dryrun_line(f"{job} x {DSHARD_SHAPE} x single, {hint} "
                               "hints", r))
        r0, r1 = rec["default"], rec["moe_dshard"]
        c0, c1 = r0["collectives"], r1["collectives"]
        gather, reduce, parts = dshard_wire_delta(
            get_config(job), SHAPE_BY_NAME[DSHARD_SHAPE])
        got = (c1["all-gather"] - c0["all-gather"],
               c1["all-reduce"] - c0["all-reduce"])
        print(f"phase10 (e) {job} moe_dshard - default: all-gather "
              f"{got[0]:.6g} (analytic {gather}), all-reduce {got[1]:.6g} "
              f"(analytic {reduce}); {parts}; the MoE dry runs' process "
              f"{wall:.1f} s with start-up (host of the {power} machine)")
        check(r0["memory"] == r1["memory"], f"phase 10 (e): {job}'s "
              f"argument bytes {r1['memory']} under moe_dshard, "
              f"{r0['memory']} without")
        check(got == (gather, reduce), f"phase 10 (e): {job}'s wire bytes "
              f"moved by {got}, analytic {(gather, reduce)}")
        out[job] = {hint: {"arg_bytes": r["memory"][
            "arg_bytes_analytic_per_device"],
            "wire_bytes": {k: v for k, v in r["collectives"].items()
                           if not k.startswith("_")},
            "roofline": {k: r["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s", "bottleneck")}}
            for hint, r in rec.items()}
    return out


def mesh_1x1():
    """(a) a 1x1 ("data", "model") NCCL mesh on the card, its process
    group started from a FileStore in a temporary directory."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = os.path.join(tempfile.mkdtemp(), "store")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1),
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    check(dist.get_backend() == "nccl" and mesh.size() == 1
          and mesh.device_type == "cuda", f"phase 10 (a): mesh {mesh}")
    print(f"phase10 (a) mesh {mesh} on {dist.get_backend()}")
    return mesh


def _one_device_train(cfg, shape, opt_cfg, param_dtype, steps: int):
    """Phase 8 (b)'s first `steps` steps of `cfg` on one device, eager:
    (losses, launch counts); what (b) compares with when phase 8 did not
    run in this process."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import build_state, put_batch
    state = build_state(cfg, opt_cfg, seed=0, device="cuda",
                        param_dtype=param_dtype)
    # eager, so that the wrappers count every step's launches as the mesh
    # step's do
    bundle = make_train_step(cfg, None, shape, opt_cfg, remat=True,
                             device="cuda", graph=False)
    pipe = TokenPipeline(cfg, shape, seed=0)
    reset_lm_counts()
    losses = []
    for i in range(steps):
        state, m = bundle.fn(state, put_batch(pipe.batch(i), "cuda"))
        losses.append(float(m["loss"]))
    counts = train_counts()
    del state, bundle
    torch.cuda.empty_cache()
    return losses, counts


def phase10b_train(mesh, power: str):
    """(b) recurrentgemma-2b's mesh train step at full width and depth on
    the 1x1 mesh with its hints installed: phase 8 (b)'s seed, batches
    and AdamW settings, MESH_STEPS steps; the losses within
    MESH_LOSS_RTOL of phase 8 (b)'s first ones and the kernels' launches
    a step equal to its.  Returns (the launches, the embedding table's
    gradient on the next batch, taken by the bundle's ``grads``)."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import make_train_step
    from repro_torch.distributed.steps import distribute
    from repro_torch.kernels import _scratch
    from repro_torch.launch.train import build_state, put_batch
    _scratch.clear()
    _free_models("phase10 (b)")
    cfg, param_dtype, shape, opt_cfg = _train_setup(TRAIN_ARCH, TRAIN_STEPS)
    ref = TRAIN_RUNS.get(TRAIN_ARCH)
    if ref is None:
        losses, counts = _one_device_train(cfg, shape, opt_cfg, param_dtype,
                                           MESH_STEPS)
        ref = {"losses": losses, "per_step": {
            k: c / MESH_STEPS for k, c in counts.items()}}
        print(f"phase10 (b) phase 8 (b) did not run: its first "
              f"{MESH_STEPS} steps run here on one device for reference")
    else:
        ref = {"losses": ref["losses"], "per_step": {
            k: c / TRAIN_STEPS for k, c in ref["counts"].items()}}
    bundle = make_train_step(cfg, mesh, shape, opt_cfg, remat=True)
    state = build_state(cfg, opt_cfg, seed=0, device="cuda",
                        param_dtype=param_dtype)
    state = distribute(state, bundle.meta["state_shardings"], mesh)
    batch_sh = bundle.meta["batch_shardings"]
    pipe = TokenPipeline(cfg, shape, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_lm_counts()
    losses, times = [], []
    for i in range(MESH_STEPS):
        batch = put_batch(pipe.batch(i), "cuda", batch_sh, mesh)
        t0 = time.perf_counter()
        state, m = bundle.fn(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: round(c * MESH_STEPS) for k, c in ref["per_step"].items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    same = losses == ref["losses"][:MESH_STEPS]
    print(f"phase10 (b) {TRAIN_ARCH} mesh train step (1x1 NCCL mesh, "
          f"hints {sorted(bundle.meta['hints'])}): losses {losses}; phase 8 "
          f"(b)'s {ref['losses'][:MESH_STEPS]}; largest relative difference "
          f"{max(rel):.3g}{' (bitwise equal)' if same else ''}")
    print(f"phase10 (b) launches {counts}; phase 8 (b)'s a step x "
          f"{MESH_STEPS}: {want}")
    print(f"phase10 (b) step times {[round(t * 1e3, 1) for t in times]} ms "
          f"(median {statistics.median(times) * 1e3:.1f} ms), peak memory "
          f"{peak / 2**30:.3f} GiB ({power})")
    check(max(rel) <= MESH_LOSS_RTOL, f"phase 10 (b): losses {losses} "
          f"against phase 8 (b)'s {ref['losses'][:MESH_STEPS]}")
    check(counts == want, f"phase 10 (b): launches {counts}, phase 8 (b)'s "
          f"{want}")
    # where a mesh step's time goes, beside phase 8's profile of the
    # one-device step
    state, _ = profile_train_step(
        bundle, state, put_batch(pipe.batch(MESH_STEPS), "cuda", batch_sh,
                                 mesh), "phase10 (b)")
    _, _, (g_embed,) = bundle.meta["grads"](
        state, put_batch(pipe.batch(MESH_STEPS + 1), "cuda", batch_sh,
                         mesh), paths={"embed/table"})
    g_embed = g_embed.to_local().detach()
    del state, bundle
    _scratch.clear()
    return counts, g_embed


def _serve_one_device(cfg, params, toks, new: int, dispatch=None):
    """`new` greedy decode steps after a prefill of `toks` (1, S) through
    ``models.model.prefill`` / ``decode_step`` on the card: (tokens, the
    prefill's seconds, a decode step's seconds, the LM kernels'
    launches), host clock around synchronised calls."""
    import torch
    from repro_torch.models import model as model_lib
    S = toks.shape[1]
    reset_lm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill(cfg, params, {"tokens": toks},
                                      S + new, dispatch=dispatch)
    out = [torch.argmax(logits, dim=-1).to(torch.int32)]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in range(new):
        pos = torch.full((1,), S + t, dtype=torch.int32, device="cuda")
        logits, cache = model_lib.decode_step(cfg, params, out[-1], pos,
                                              cache, dispatch)
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / new
    return torch.cat(out).tolist(), t_prefill, t_decode, lm_counts()


def _serve_mesh(cfg, mesh, params, toks, new: int, extra_hints=None,
                dparams=None):
    """The same through ``make_prefill_step`` / ``make_decode_step`` on
    `mesh` (`extra_hints` for both): (tokens, the prefill's seconds, a
    decode step's seconds, the LM kernels' launches, the parameters as
    distributed, the step's dispatch).  `params` are distributed by the
    prefill step's shardings unless `dparams` holds them so already."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.distributed import make_decode_step, make_prefill_step
    from repro_torch.distributed.steps import distribute
    S = toks.shape[1]
    L = S + new
    pb = make_prefill_step(cfg, mesh, InputShape("p10", S, 1, "prefill"),
                           extra_hints=extra_hints, cache_len=L)
    db = make_decode_step(cfg, mesh, InputShape("d10", L, 1, "decode"),
                          extra_hints=extra_hints)
    if dparams is None:
        dparams = distribute(params, pb.meta["params_shardings"], mesh)
    reset_lm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, cache = pb.fn(dparams, {"tokens": toks})
    out = [torch.argmax(tok.full_tensor(), dim=-1).to(torch.int32)]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in range(new):
        pos = torch.full((1,), S + t, dtype=torch.int32, device="cuda")
        nxt, cache = db.fn(dparams, cache, out[-1], pos)
        out.append(nxt.full_tensor())
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / new
    return (torch.cat(out).tolist(), t_prefill, t_decode, lm_counts(),
            dparams, pb.meta["dispatch"])


def phase10c_serve(mesh, power: str) -> dict:
    """(c) gemma2-2b at its published width through ``make_prefill_step``
    / ``make_decode_step`` on the 1x1 mesh: each prompt of MESH_PROMPTS
    alone, then MESH_NEW greedy decode steps; the tokens equal to the
    one-device path's (``models.model.prefill`` / ``decode_step``) on the
    same weights and prompts, and the flash kernel's launches too."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    _free_models("phase10 (c)")
    cfg = get_config(GEMMA_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(10)
    launches = {"one-device": {}, "mesh": {}}
    dparams = None
    for S in MESH_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                               dtype=torch.int32, device="cuda")
        w, one_prefill, one_decode, launches["one-device"][S] = \
            _serve_one_device(cfg, params, toks, MESH_NEW)
        g, t_prefill, t_decode, launches["mesh"][S], dparams, _ = \
            _serve_mesh(cfg, mesh, params, toks, MESH_NEW, dparams=dparams)
        print(f"phase10 (c) {GEMMA_ARCH} {S}-token prompt: mesh tokens {g}; "
              f"one-device {w}; {'equal' if g == w else 'DIFFER'}; mesh "
              f"prefill {t_prefill * 1e3:.1f} ms, decode step "
              f"{t_decode * 1e3:.1f} ms; one-device prefill "
              f"{one_prefill * 1e3:.1f} ms, decode step "
              f"{one_decode * 1e3:.1f} ms ({power}); flash launches mesh "
              f"{launches['mesh'][S]['flash_attention']} "
              f"(wgmma {launches['mesh'][S]['flash_attention.wgmma']}), "
              f"one-device {launches['one-device'][S]['flash_attention']}")
        check(g == w, f"phase 10 (c): {S}-token prompt: tokens {g} on the "
              f"mesh, {w} on one device")
        check(launches["mesh"][S] == launches["one-device"][S],
              f"phase 10 (c): launches {launches['mesh'][S]} on the mesh, "
              f"{launches['one-device'][S]} on one device")
    del params, dparams
    return launches


def phase10d_compress(g, power: str):
    """(d) ``compressed_psum`` over the 1-rank process group on (b)'s
    embedding gradient: the mean and the residual bitwise ``ef_quantize``
    / ``dequantize`` on the CPU; its time (median of 5, CUDA events)."""
    import torch
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize, ef_quantize)
    err = torch.zeros_like(g, dtype=torch.float32)
    mean, new_err = compressed_psum(g, None, err)
    q, s, ne = ef_quantize(g.cpu(), err.cpu())
    same = (torch.equal(mean.cpu(), dequantize(q, s))
            and torch.equal(new_err.cpu(), ne))
    ms = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        compressed_psum(g, None, err)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    print(f"phase10 (d) compressed_psum of the embedding gradient "
          f"{tuple(g.shape)} {str(g.dtype)[6:]}: mean and residual "
          f"{'bitwise equal to' if same else 'DIFFER from'} ef_quantize / "
          f"dequantize on the CPU; {statistics.median(ms):.3f} ms (median "
          f"of 5, {power})")
    check(same, "phase 10 (d): compressed_psum differs from the CPU's "
          "ef_quantize / dequantize")


def phase10f_moe_dshard(mesh, power: str) -> dict:
    """(f) deepseek-v2-236b at its published width, depth cut to
    MOE_TRAIN_LAYERS (the dense first layer and one MoE layer), bf16
    weights (the router f32) from a seeded generator, through
    ``make_prefill_step`` / ``make_decode_step`` on the 1x1 mesh under
    the default hints and under ``moe_dshard`` (the expert weights kept
    as stored, d split on "data", the gate and up products all-reduced
    over it: here a group of one): each prompt of MESH_PROMPTS alone,
    then DSHARD_NEW greedy decode steps; the tokens equal to the
    one-device path's on the same weights, prompts and dispatch, the
    flash launches equal to its (one a layer a prefill, all on the
    wgmma kernel at MLA's q/k 192, v 128); each path run twice, the
    second timed (host clock).  Returns the launches by hints and prompt
    length."""
    import gc
    import numpy as np
    import torch
    from repro_torch.distributed.steps import moe_dshard_hints
    from repro_torch.models import model as model_lib
    _free_models("phase10 (f)")
    cfg, param_dtype, _ = _train_config(MOE_ARCH, MOE_TRAIN_LAYERS)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    check(n_moe == MOE_TRAIN_LAYERS - 1, f"phase 10 (f): {n_moe} MoE layers")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
        param_dtype=param_dtype)
    rng = np.random.default_rng(11)
    hints = {"default": None, "moe_dshard": moe_dshard_hints(mesh)}
    launches = {"one-device": {}, **{h: {} for h in hints}}
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                           dtype=torch.int32, device="cuda")
    # the step's dispatch, which the one-device path takes too; the
    # process group's first collective (moe_dshard's all-reduce)
    *_, dparams, disp = _serve_mesh(cfg, mesh, params, toks, 1)
    _serve_mesh(cfg, mesh, params, toks, 1, hints["moe_dshard"], dparams)
    for S in MESH_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                               dtype=torch.int32, device="cuda")
        # each path twice, the second timed: the first meets this
        # prompt length's first allocations and cuBLAS choices
        firsts = [_serve_one_device(cfg, params, toks, DSHARD_NEW, disp)
                  for _ in range(2)]
        w, one_prefill, one_decode, one = firsts[1]
        check(firsts[0][0] == w, f"phase 10 (f): {S}-token prompt: one "
              f"device's tokens {firsts[0][0]}, then {w}")
        launches["one-device"][S] = one
        runs = {}
        for h, extra in hints.items():
            for first in (True, False):
                g, t_prefill, t_decode, n, _, _ = _serve_mesh(
                    cfg, mesh, params, toks, DSHARD_NEW, extra, dparams)
                check(g == w, f"phase 10 (f): {S}-token prompt, {h} hints"
                      f"{' (first run)' if first else ''}: tokens {g} on "
                      f"the mesh, {w} on one device")
            runs[h] = (g, t_prefill, t_decode, n)
        for h, (g, t_prefill, t_decode, n) in runs.items():
            launches[h][S] = n
            print(f"phase10 (f) {MOE_ARCH} ({cfg.n_layers} layers, {n_moe} "
                  f"MoE, "
                  f"dispatch {disp}) {S}-token prompt, {h} hints: mesh "
                  f"tokens {g}; one-device {w}; "
                  f"{'equal' if g == w else 'DIFFER'}; mesh prefill "
                  f"{t_prefill * 1e3:.1f} ms, decode step "
                  f"{t_decode * 1e3:.1f} ms; one-device prefill "
                  f"{one_prefill * 1e3:.1f} ms, decode step "
                  f"{one_decode * 1e3:.1f} ms ({power}); flash launches "
                  f"{n['flash_attention']} (wgmma "
                  f"{n['flash_attention.wgmma']}), one-device "
                  f"{one['flash_attention']}")
            check(n == one, f"phase 10 (f): {h} hints: launches {n} on the "
                  f"mesh, {one} on one device")
        check(one["flash_attention"] == one["flash_attention.wgmma"]
              == cfg.n_layers, f"phase 10 (f): flash launches {one}, "
              f"{cfg.n_layers} wgmma a prefill wanted")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase10_mesh(dryruns: dict) -> dict:
    """Phase 10's parts in order, (e) printing the dry runs' records
    (run beside phase 0's build); the process group ended at the end.
    Returns (b)'s, (c)'s and (f)'s launches and (e)'s MoE records."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    power = card()
    try:
        mesh = mesh_1x1()
        train, g = phase10b_train(mesh, power)
        serve = phase10c_serve(mesh, power)
        phase10d_compress(g, power)
        del g
        dshard = phase10e_dryruns(dryruns, power)
        t_f = time.perf_counter()
        moe = phase10f_moe_dshard(mesh, power)
        t_f = time.perf_counter() - t_f
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"phase10 total {time.perf_counter() - t0:.1f} s ((f) {t_f:.1f} "
          "s)")
    return {"train": train, "serve": serve, "moe": moe, "dshard": dshard}


# ---------------------------------------------------------------------------
# phase 11: the other six architectures
# ---------------------------------------------------------------------------

#: phase 11: the six architectures no earlier phase serves, each at its
#: published width, bf16 compute, prompts of these lengths (two each)
OTHER_PROMPTS = (512, 3000)
#: gemma3-12b's prompts cross its local window of 1,024
GEMMA3_PROMPTS = (2048, 3000)
#: qwen1.5-110b cut from 80 layers (220 GB of bf16 weights) to 8 (26.7 GB)
QWEN_LAYERS = 8
#: llama4-maverick cut from 48 layers to one period: chunked dense,
#: chunked MoE, chunked dense, global no-RoPE MoE (70.6 GB of bf16
#: weights, 128 experts of d_ff 8,192 in each MoE layer)
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 4
#: llama4's long prompt crosses one boundary of its 8,192-token chunks;
#: its plain version is left out (40 heads x 10^8 scores x 4 B = 16 GB a
#: tensor), and its flash outputs are held 4 query rows at a time beside
#: the weights
LLAMA4_LONG, LLAMA4_MAX_LEN, LLAMA4_STASH_ROWS = 10000, 10240, 4
#: internvl2-2b: its 256 projected patch embeddings, then prompts of
#: these lengths, and greedy decode steps for VLM_NEW tokens in all
VLM_ARCH = "internvl2-2b"
VLM_TEXT = (512, 3000)
VLM_NEW = SERVE_MAX_NEW
#: hubert-xlarge (encoder-only, no decode step): forwards over (batch,
#: frames): 60 s of audio and four clips of 20 s at 50 frames a second
AUDIO_ARCH = "hubert-xlarge"
AUDIO_SHAPES = ((1, 3000), (4, 1000))
#: phase 11 (g): the layers of each architecture whose gradients are held
#: on the card at S PERIOD_SEQ: its first layer, gemma3-12b's whole period
GRAD_LAYERS = {"gemma-7b": 1, "gemma3-12b": 6, "qwen1.5-110b": 1,
               LLAMA4_ARCH: 1, VLM_ARCH: 1, AUDIO_ARCH: 1}


def phase11_served(letter: str, arch: str, prompt_lengths, n_layers: int = 0,
                   bf16_weights: bool = False, **serve) -> dict:
    """(a)-(d) `arch` served as phase 5 serves (``serve_full_width``),
    after the earlier models are freed: at its published width, its depth
    cut to `n_layers` where given, f32 weights (bf16 with `bf16_weights`),
    bf16 compute; every prefill launches one flash kernel a layer, on the
    path ``path`` names for its head dim (all wgmma).  Prints the model's
    peak memory and time.  Returns the kernels' launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import path
    from repro_torch.models.model import layer_specs
    t0 = time.perf_counter()
    phase = f"phase11{letter}"
    _free_models(f"phase11 ({letter})")
    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers) if n_layers else full
    kinds = cfg.layer_kinds()
    d = cfg.resolved_head_dim()
    kernel = path(torch.bfloat16, d, cfg.attn_softcap)
    check(cfg.dtype == "bfloat16" and kernel == "wgmma",
          f"phase 11 ({letter}): {arch} computes in {cfg.dtype} on {kernel}")
    thetas = sorted({s.rope_theta for s in layer_specs(cfg)})
    label = (", ".join(f"{kinds.count(k)} {k}"
                       + ("" if k == "global" else f" (window {cfg.window})")
                       for k in dict.fromkeys(kinds))
             + f", {cfg.n_heads} query heads over {cfg.n_kv_heads} kv heads "
             f"of {d}, RoPE theta {thetas} (0: none)"
             + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
                f"{cfg.moe.d_ff_expert} + {cfg.moe.n_shared_experts} shared"
                if cfg.moe else "")
             + (", QKV bias" if cfg.qkv_bias else "")
             + (", qk-norm" if cfg.qk_norm else ""))
    launches, peak = serve_full_width(
        phase, arch, prompt_lengths, 110 + ord(letter) - ord("a"),
        flash_launches(cfg.n_layers, kernel), label, cfg=cfg,
        param_dtype=torch.bfloat16 if bf16_weights else None, **serve)
    print(f"phase11 ({letter}) {arch} peak memory {peak / 2**30:.3f} GiB "
          f"(the kernels' drain, weights included); "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def _held_steps(label: str, got, want) -> str:
    """Each step's logits of a greedy run through the kernels (`got`)
    against the plain run's (`want`), lists of (logits row, token), while
    the two agree: within LOGIT_TOL of the largest |logit| (phase 5's
    limit), the same token wherever the plain run's top-2 margin exceeds
    that.  After a token that differs where the margin is within that,
    the two continue from other tokens and are not compared."""
    import torch
    worst, checked, steps = 0.0, 0, 0
    for i, ((lk, tk), (lp, tp)) in enumerate(zip(got, want)):
        check(bool(torch.isfinite(lk).all()),
              f"{label} step {i}: logits not finite")
        scale = float(lp.abs().max())
        err = float((lk - lp).abs().max())
        check(err <= LOGIT_TOL * scale, f"{label} step {i}: logits differ "
              f"by {err} of max |logit| {scale}")
        worst, steps = max(worst, err / scale), steps + 1
        top2 = torch.topk(lp, 2).values
        if float(top2[0] - top2[1]) > LOGIT_TOL * scale:
            checked += 1
            check(tk == tp, f"{label} step {i}: token {tk} against {tp}")
        if tk != tp:
            break
    return (f"{steps} steps held (worst {worst:.5f} of max |logit|), tokens "
            f"checked at {checked}")


def phase11e_internvl2() -> dict:
    """(e) internvl2-2b at its published width and depth (24 layers,
    d_model 2,048, 16 query heads over 8 kv heads of 128), f32 weights,
    bf16 compute, its vision frontend's 256 projected patch embeddings
    (InternViT's width 1,024, drawn from a seed) before prompts of
    VLM_TEXT tokens: ``model.prefill`` with the cache sized for both and
    VLM_NEW - 1 greedy steps of the serving engine's ``DecodeStep`` on
    that cache (the engine takes tokens alone, as the reference's does),
    through the kernels, the steps captured in a graph, and through their
    plain versions, the steps eager.  Every prefill launches 24 flash
    kernels, all on the wgmma path; the logits of every step held as
    phase 5 holds a prefill's; a captured step held against an eager one
    from the kernels' prefill's cache (``hold_graph``).  Returns the
    kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import DecodeStep
    t0 = time.perf_counter()
    _free_models("phase11 (e)")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM_ARCH)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    dev = model_lib.params_device(params)
    n_front = cfg.n_frontend_tokens
    print(f"phase11e {VLM_ARCH}: {sum(t.numel() for t in _leaves(params)):,}"
          f" parameters (f32, computed in {cfg.dtype}; the config's "
          f"estimate {cfg.param_count():,}), {cfg.n_layers} global layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} query heads over "
          f"{cfg.n_kv_heads} kv heads of {cfg.resolved_head_dim()}, "
          f"{n_front} patch embeddings of {cfg.frontend_dim} projected")
    want = flash_launches(cfg.n_layers, "wgmma")
    rng = np.random.default_rng(115)

    def run(batch, n_text, use_kernel):
        """prefill, then greedy decode steps through the serving engine's
        step on the prefill's cache (captured with the kernels, eager
        through the plain versions): ([(logits, token)], the prefill's
        launches, prefill ms, decode s, the step, a copy of the cache as
        the prefill left it)"""
        reset_lm_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        L = n_front + n_text + VLM_NEW
        logits, cache = model_lib.prefill(cfg, params, batch, L,
                                          use_kernel=use_kernel)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t)
        launches = lm_counts()
        copy = ([{k: v.clone() for k, v in layer.items()} for layer in cache]
                if use_kernel else None)
        step = DecodeStep(cfg, params, cache, 1, L, dev, graph=use_kernel)
        steps = [(logits[0].float().cpu(), int(logits[0].argmax()))]
        t = time.perf_counter()
        for i in range(VLM_NEW - 1):
            nxt = step(np.array([steps[-1][1]], np.int64),
                       np.array([n_front + n_text + i], np.int64))
            steps.append((step.logits[0].float().cpu(), int(nxt[0])))
        dec_s = time.perf_counter() - t
        check(step.replays == (VLM_NEW - 1 if use_kernel else 0),
              f"phase 11 (e): {step.replays} replays for {VLM_NEW - 1} "
              "steps")
        return steps, launches, prefill_ms, dec_s, step, copy

    def batch_of(n_text):
        patches = rng.standard_normal((1, n_front, cfg.frontend_dim))
        return {"patch_embeds": torch.from_numpy(
                    patches.astype(np.float32)).to(dev),
                "tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (1, n_text))).to(dev)}

    run(batch_of(64), 64, True)  # warm-up, not counted
    total = {k: 0 for k in want}
    for n_text in VLM_TEXT:
        batch = batch_of(n_text)
        got, launches, k_ms, k_s, step, copy = run(batch, n_text, True)
        check(launches == want, f"phase 11 (e) prefill of {n_text}: "
              f"launches {launches}, expected {want}")
        total = {k: total[k] + launches[k] for k in total}
        capture_ms = step.capture_ms
        step.close()
        del step
        plain, launches_p, p_ms, p_s, _, _ = run(batch, n_text, False)
        check(not any(launches_p.values()), f"phase 11 (e): the plain run "
              f"launched kernels {launches_p}")
        held = _held_steps(f"phase 11 (e) prompt {n_text}", got, plain)
        print(f"phase11e {n_front} patches + {n_text} tokens: prefill "
              f"{k_ms:.2f} ms (plain {p_ms:.2f}), {VLM_NEW - 1} decode "
              f"steps {k_s:.3f} s graphed, {VLM_NEW - 1} replays, capture "
              f"{capture_ms:.2f} ms (plain, eager: {p_s:.3f} s); tokens "
              f"{[t for _, t in got][:6]}...; {held}")
        # the graph against eager from the kernels' prefill's cache
        L = n_front + n_text + VLM_NEW
        graphed = DecodeStep(cfg, params, copy, 1, L, dev)
        hold_graph(f"phase11e prompt {n_text}", cfg, params, graphed,
                   np.array([got[0][1]], np.int64),
                   np.array([n_front + n_text], np.int64))
        graphed.close()
        del graphed, copy
    print(f"phase11 (e) {VLM_ARCH} launches {total} ({want} per prefill); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; {time.perf_counter() - t0:.1f} s")
    return total


def phase11f_hubert() -> dict:
    """(f) hubert-xlarge at its published width and depth (48 layers,
    d_model 1,280, 16 heads of 80, encoder-only, so non-causal), f32
    weights, bf16 compute, through ``model.forward`` on audio frames of
    width 512 (its conv frontend's, drawn from a seed) at AUDIO_SHAPES,
    through the kernels and through their plain versions: every forward
    launches 48 flash kernels, all on the wgmma path (head dim 80 kept
    as two 64-column blocks, the last 48 columns zero), and takes less
    time than the plain versions' forward.  Its own bf16 rounding moves
    the (B, S, 504) logits past phase 5's limit (48 layers; |logit| up to some 170), so
    they are held as phase 9 (b) holds gemma2-2b's, against a witness:
    the same forward in f32 through the plain versions.  The kernels'
    run no farther from it in norm than WITNESS_RATIO times the plain
    run is, and the same argmax as the witness at every frame whose
    witness top-2 margin exceeds 2 WITNESS_RATIO times the plain run's
    largest deviation from the witness at that frame (phase 5's rule,
    with the tolerance the plain run's own bf16 rounding).  Returns the
    kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import path
    from repro_torch.models import model as model_lib
    t0 = time.perf_counter()
    _free_models("phase11 (f)")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(AUDIO_ARCH)
    d = cfg.resolved_head_dim()
    check(path(torch.bfloat16, d) == "wgmma" and cfg.encoder_only,
          f"phase 11 (f): {AUDIO_ARCH} at head dim {d} is not on the "
          "wgmma path")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    dev = model_lib.params_device(params)
    print(f"phase11f {AUDIO_ARCH}: {sum(t.numel() for t in _leaves(params)):,}"
          f" parameters (f32, computed in {cfg.dtype}; the config's "
          f"estimate {cfg.param_count():,}), {cfg.n_layers} non-causal "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {d}, "
          f"frames of {cfg.frontend_dim}, vocabulary {cfg.vocab_size}")
    want = flash_launches(cfg.n_layers, "wgmma")
    rng = np.random.default_rng(116)

    def run(frames, use_kernel, dtype=cfg.dtype):
        reset_lm_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = model_lib.forward(cfg.replace(dtype=dtype), params,
                                   {"frames": frames}, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return logits.float(), lm_counts(), time.perf_counter() - t

    def frames_of(B, S):
        return torch.from_numpy(rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)).to(dev)

    run(frames_of(1, 256), True)  # warm-up, not counted
    # and both paths at every measured shape (on zeros, so the frames
    # drawn below are the same), so that neither timed run pays for the
    # allocator's first blocks of its shape
    for B, S in AUDIO_SHAPES:
        for use_kernel in (True, False):
            run(torch.zeros((B, S, cfg.frontend_dim), device=dev), use_kernel)
    total = {k: 0 for k in want}
    for B, S in AUDIO_SHAPES:
        frames = frames_of(B, S)
        lk, launches, k_s = run(frames, True)
        check(launches == want, f"phase 11 (f) forward ({B}, {S}): "
              f"launches {launches}, expected {want}")
        total = {k: total[k] + launches[k] for k in total}
        lp, launches_p, p_s = run(frames, False)
        check(not any(launches_p.values()), f"phase 11 (f): the plain run "
              f"launched kernels {launches_p}")
        check(lk.shape == (B, S, cfg.vocab_size)
              and bool(torch.isfinite(lk).all()),
              f"phase 11 (f): logits {tuple(lk.shape)}, finite "
              f"{bool(torch.isfinite(lk).all())}")
        lf, _, f_s = run(frames, False, "float32")
        scale = float(lp.abs().max())
        err = float((lk - lp).abs().max())
        kp, kf, pf = (float((a - b).norm() / b.norm())
                      for a, b in ((lk, lp), (lk, lf), (lp, lf)))
        # the frames whose f32 top-2 margin is wider than twice
        # WITNESS_RATIO times the plain run's own largest deviation there:
        # bf16 rounding of that size cannot flip them
        top2 = torch.topk(lf, 2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1])
                 > 2 * WITNESS_RATIO * (lp - lf).abs().amax(-1))
        best = lf.argmax(-1)
        miss_k = int((clear & (lk.argmax(-1) != best)).sum())
        miss_p = int((clear & (lp.argmax(-1) != best)).sum())
        print(f"phase11f forward ({B}, {S}): kernels {k_s * 1e3:.2f} ms, "
              f"plain {p_s * 1e3:.2f} ms, f32 plain {f_s * 1e3:.2f} ms; "
              f"logits max_abs_err {err:.4f} of max |logit| {scale:.2f} "
              f"(phase 5's tol {LOGIT_TOL * scale:.4f}, not held); in "
              f"norm: kernels against plain {kp:.5f}, against f32 "
              f"{kf:.5f}, the plain run against f32 {pf:.5f} (tol "
              f"{WITNESS_RATIO} times); of the {int(clear.sum())} of "
              f"{clear.numel()} frames whose f32 top-2 margin exceeds "
              f"{2 * WITNESS_RATIO} times the plain run's largest "
              f"deviation there, the f32 argmax missed at {miss_k} "
              f"through the kernels, {miss_p} through the plain versions")
        check(kf <= WITNESS_RATIO * pf, f"phase 11 (f) forward ({B}, {S}): "
              f"logits {kf} from f32 in norm, the plain run {pf}")
        check(k_s < p_s, f"phase 11 (f) forward ({B}, {S}): "
              f"{k_s * 1e3:.2f} ms through the kernels, {p_s * 1e3:.2f} "
              "ms through the plain versions")
        check(miss_k == 0, f"phase 11 (f) forward ({B}, {S}): the f32 "
              f"argmax missed at {miss_k} frames whose margin bf16 "
              "rounding cannot flip")
    print(f"phase11 (f) {AUDIO_ARCH} launches {total} ({want} per forward); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; {time.perf_counter() - t0:.1f} s")
    return total


def phase11h_flash_shapes(power: str) -> tuple:
    """(h) the flash kernel at the four shapes the six bring to the card,
    bf16, forward and backward, timed as phases 4 and 8 (a) time theirs
    (``hold_flash``, ``hold_flash_bwd``: against the plain versions, the
    backward bitwise over two calls, beside the CUDA-core kernels, the
    bounds and one scaled_dot_product_attention call, or its backward,
    with the same boolean mask): qwen1.5-110b's 64 query heads over 8 kv
    heads of 128, causal, S 3,000; llama4's 40 over 8 of 128, chunked in
    8,192, S 10,000 (the plain backward a kv head at a time);
    gemma3-12b's 16 over 8 of 256, local 1,024, S 3,000; hubert-xlarge's
    16 heads of 80, non-causal, S 3,000, where each direction's device
    time must be below sdpa's.  Returns the forward's and the backward's
    measurements."""
    import torch
    from repro_torch.configs import get_config
    _free_models("phase11 (h)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    times, bwd_times = [], []
    for arch, s, kind, causal in (
            ("qwen1.5-110b", 3000, "global", True),
            (LLAMA4_ARCH, LLAMA4_LONG, "chunked", True),
            ("gemma3-12b", 3000, "local", True),
            (AUDIO_ARCH, 3000, "global", False)):
        cfg = get_config(arch)
        bh, bh_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
        q, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (bh, bh_kv, bh_kv))
        window = cfg.window if kind != "global" else 0
        kw = dict(causal=causal, kind=kind, window=window)
        m = hold_flash(q, k, v, kw, with_library=True)
        simt = ("" if "simt_ms" not in m else
                f", simt kernel {m['simt_ms']:.4f} ms (device "
                f"{m['simt_device_ms']:.4f} ms)")
        print(f"phase11 flash_attention {arch} BH={bh} G={bh // bh_kv} "
              f"S={s} D={d} {kind} {window} causal={causal} bfloat16 "
              f"path={m['path']}: max_abs_err {m['max_abs_err']:.3g} "
              f"({m['worst']:.3g} of the allowance), kernel {m['ms']:.4f} "
              f"ms (device {m['device_ms']:.4f} ms){simt}, plain "
              f"{m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} ms "
              f"(device {m['library_device_ms']:.4f} ms), bound "
              f"{m['bound_ms']:.5f} ms ({m['bound_by']}), pairs "
              f"{m['pairs']}; {power}")
        times.append(dict({key: m[key] for key in (
            "path", "max_abs_err", "ms", "device_ms", "simt_ms",
            "simt_device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by") if key in m},
            arch=arch, shape=[bh, bh_kv, s, d], kind=kind, window=window,
            causal=causal, source=CSRC + ("flash_attention.cu"
                                          if m["path"] == "simt"
                                          else SOURCES["flash_attention"])))
        b = hold_flash_bwd(q, k, v, kw, timed=True, twice=True,
                           plain_kv_rows=1 if s > 3000 else 0)
        print(flash_bwd_line(f"{arch} BH={bh} G={bh // bh_kv} S={s} D={d} "
                             f"{kind} {window} causal={causal} bfloat16", b,
                             "phase11") + f"; {power}")
        bwd_times.append(dict({key: b[key] for key in (
            "path", "max_abs_err", "bitwise_twice", "ms", "device_ms",
            "simt_ms", "simt_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by") if key in b},
            arch=arch, shape=[bh, bh_kv, s, d], kind=kind, window=window,
            causal=causal, source=CSRC + (
                "flash_attention_bwd.cu" if b["path"] == "simt"
                else "flash_attention_bwd_wgmma.cu")))
        if arch == AUDIO_ARCH:
            for label, t in (("forward", m), ("backward", b)):
                check(t["device_ms"] < t["library_device_ms"],
                      f"phase 11 (h) {arch} {label}: device "
                      f"{t['device_ms']:.4f} ms, sdpa's "
                      f"{t['library_device_ms']:.4f} ms")
        del q, k, v
    return times, bwd_times


def phase11_other_archs() -> dict:
    """Phase 11's parts in order, each model freed before the next: (a)
    gemma-7b, (b) gemma3-12b, (c) qwen1.5-110b cut to QWEN_LAYERS, (d)
    llama4-maverick cut to one period, served; (e) internvl2-2b through
    prefill and decode; (f) hubert-xlarge's forward; (g) each one's first
    layers' gradients (``phase8_period_grads``); (h) the flash kernel at
    their new shapes.  Returns the launches by path of (a)-(f) and (g)
    and (h)'s times."""
    t0 = time.perf_counter()
    power = card()
    served = {
        "gemma-7b": phase11_served("a", "gemma-7b", OTHER_PROMPTS),
        "gemma3-12b": phase11_served("b", "gemma3-12b", GEMMA3_PROMPTS,
                                     bf16_weights=True),
        "qwen1.5-110b": phase11_served("c", "qwen1.5-110b", OTHER_PROMPTS,
                                       QWEN_LAYERS, bf16_weights=True),
        LLAMA4_ARCH: phase11_served(
            "d", LLAMA4_ARCH, OTHER_PROMPTS + (LLAMA4_LONG,), LLAMA4_LAYERS,
            bf16_weights=True, max_len=LLAMA4_MAX_LEN,
            n_plain=2 * len(OTHER_PROMPTS), stash_rows=LLAMA4_STASH_ROWS),
        VLM_ARCH: phase11e_internvl2(),
        AUDIO_ARCH: phase11f_hubert()}
    t_grads = time.perf_counter()
    _free_models("phase11 (g)")
    # qwen1.5-110b's sit nearest the limit: split apart by an f32 witness
    grads = {arch: phase8_period_grads(arch, witness=arch == "qwen1.5-110b")
             for arch in GRAD_LAYERS}
    print(f"phase11 (g) gradients of the six: "
          f"{time.perf_counter() - t_grads:.1f} s")
    times, bwd_times = phase11h_flash_shapes(power)
    print(f"phase11 total {time.perf_counter() - t0:.1f} s; {power}")
    return {"served": served, "grads": grads, "times": times,
            "bwd_times": bwd_times}


# ---------------------------------------------------------------------------
# phase 12: the architectures that fit one card, trained at published width
# ---------------------------------------------------------------------------

#: phase 12 (a)-(f), in order: each trained as TRAIN_TABLE says;
#: llama4-maverick is not, its one MoE layer's experts alone being 129 GB
#: of bf16 state
PHASE12_ARCHS = (GEMMA_ARCH, "gemma-7b", "gemma3-12b", "qwen1.5-110b",
                 VLM_ARCH, AUDIO_ARCH)
PHASE12_STEPS = 4
#: the runs with one more (graphed) step under the profiler: all, for
#: each model's busy time and idle share beside its step times
PHASE12_PROFILED = PHASE12_ARCHS
#: phase 12 (g): the steps of the train loop held bitwise to (f)'s first
PHASE12_LOOP_STEPS = 3


def phase12g_train_loop() -> dict:
    """(g) hubert-xlarge through ``launch/train.py``'s ``train_loop`` on
    the card, (f)'s AdamW settings, PHASE12_LOOP_STEPS steps: its losses
    bitwise (f)'s first ones (the same seed, pipeline and state route;
    the loop builds f32 state, as (f) trains hubert; both through the
    captured step) and its launches exact (``CaptureCounts``: one capture,
    T - 1 replays).  Returns the launches."""
    import torch
    from repro_torch.launch.train import train_loop
    _free_models("phase12 (g)")
    cfg, param_dtype, shape, opt_cfg = _train_setup(AUDIO_ARCH,
                                                    PHASE12_STEPS)
    check(param_dtype == torch.float32, f"phase 12 (g): {AUDIO_ARCH} "
          f"trains in {param_dtype}, the loop in f32")
    n, fwd, _ = _layer_counts(cfg)
    T = PHASE12_LOOP_STEPS
    reset_lm_counts()
    t0 = time.perf_counter()
    with CaptureCounts() as cc:
        _state, losses = train_loop(cfg, shape, steps=T, opt_cfg=opt_cfg,
                                    device="cuda", log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del _state
    check(len(cc.marks) == 1, f"phase 12 (g): {len(cc.marks)} captures")
    counts = cc.launched([T - 1])
    want = {k: 0 for k in counts}
    per_run = TRAIN_RUNS[AUDIO_ARCH]["counts"]
    want.update({"flash_attention": fwd["attention"] * T,
                 "flash_attention.wgmma": fwd["attention"] * T,
                 "flash_attention_bwd": n["attention"] * T,
                 "flash_attention_bwd.wgmma": n["attention"] * T,
                 "adamw_update": per_run["adamw_update"] // PHASE12_STEPS * T,
                 "grad_norm": T})
    ref = TRAIN_RUNS[AUDIO_ARCH]["losses"][:T]
    print(f"phase12 (g) {AUDIO_ARCH} train_loop: losses {losses} against "
          f"(f)'s {ref}; launches {counts}, expected {want}; {wall:.2f} s, "
          "state built in the loop")
    check(losses == ref, f"phase 12 (g): train_loop's losses {losses}, "
          f"(f)'s {ref}")
    check(counts == want, f"phase 12 (g): launches {counts}, expected "
          f"{want}")
    return counts


#: phase 12 (i): the attention shapes (a)-(f) give the kernels at S
#: TRAIN_SEQ that no earlier phase holds there, as (architecture, mask
#: kind); the others are phase 11 (h)'s
PHASE12_FLASH_SHAPES = ((GEMMA_ARCH, "local"), (GEMMA_ARCH, "global"),
                        ("gemma-7b", "global"), (VLM_ARCH, "global"))


def phase12i_flash_shapes() -> list:
    """(i) the flash kernel, forward and backward, at each of
    PHASE12_FLASH_SHAPES as the train step gives it (B 1, S TRAIN_SEQ,
    bf16, causal, the config's heads, head dim, window and softcap):
    held against the plain versions (``hold_flash``, ``hold_flash_bwd``;
    the backward bitwise over two calls) and timed beside them, the
    CUDA-core kernels, the bound and the library: sdpa (with
    `enable_gqa` forward; k and v repeated backward), or with gemma2-2b's
    softcap one compiled flex_attention call, forward and backward.
    Returns each shape's paths and errors."""
    import torch
    from repro_torch.configs import get_config
    _free_models("phase12 (i)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    held = []
    for arch, kind in PHASE12_FLASH_SHAPES:
        cfg = get_config(arch)
        bh, bh_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
        q, k, v = (torch.randn((n, TRAIN_SEQ, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for n in (bh, bh_kv, bh_kv))
        kw = dict(causal=True, kind=kind,
                  window=cfg.window if kind == "local" else 0)
        if cfg.attn_softcap:
            kw["softcap"] = cfg.attn_softcap
        m = hold_flash(q, k, v, kw, with_library=True)
        b = hold_flash_bwd(q, k, v, kw, timed=True, twice=True)
        what = (f"{arch} BH={bh} G={bh // bh_kv} S={TRAIN_SEQ} D={d} "
                f"{kw} bfloat16")
        setup = (f", mask and compile {m['library_setup_s']:.1f} s"
                 if "library_setup_s" in m else "")
        print(f"phase12 (i) flash_attention {what} path={m['path']}: "
              f"max_abs_err {m['max_abs_err']:.3g} ({m['worst']:.3g} of "
              f"the allowance), kernel {m['ms']:.4f} ms (device "
              f"{m['device_ms']:.4f} ms) [CUDA cores {m['simt_ms']:.4f} ms, "
              f"device {m['simt_device_ms']:.4f}], plain "
              f"{m['plain_ms']:.4f} ms, {m['library']} "
              f"{m['library_ms']:.4f} ms (device "
              f"{m['library_device_ms']:.4f} ms{setup}), bound "
              f"{m['bound_ms']:.5f} ms ({m['bound_by']}), pairs "
              f"{m['pairs']} a head")
        print(flash_bwd_line(what, b, "phase12 (i)")
              + (f"; {b['library']} mask and compiles "
                 f"{b['library_setup_s']:.1f} s"
                 if "library_setup_s" in b else ""))
        held.append({"arch": arch, "shape": [bh, bh_kv, TRAIN_SEQ, d],
                     **kw, "path": m["path"],
                     "max_abs_err": m["max_abs_err"], "bwd_path": b["path"],
                     "bwd_max_abs_err": b["max_abs_err"],
                     "bwd_bitwise_twice": b["bitwise_twice"],
                     "kv_shares": m.get("kv_shares"),
                     **{key: m[key] for key in (
                         "ms", "device_ms", "library", "library_ms",
                         "library_device_ms", "bound_ms")},
                     **{"bwd_" + key: b[key] for key in (
                         "ms", "device_ms", "library_ms",
                         "library_device_ms", "bound_ms")}})
        if cfg.attn_softcap:
            # the softcapped forward against one flex_attention call
            check(m["device_ms"] < m["library_device_ms"],
                  f"phase 12 (i) {arch} {kind} forward: device "
                  f"{m['device_ms']:.4f} ms, flex_attention's "
                  f"{m['library_device_ms']:.4f} ms")
            print(f"phase12 (i) {arch} {kind}: the kernel's forward at "
                  f"{m['device_ms'] / m['library_device_ms']:.3f}x "
                  f"flex_attention's device time, "
                  f"{m['bound_ms'] / m['device_ms']:.1%} of its bound; "
                  f"backward {b['device_ms'] / b['library_device_ms']:.3f}x "
                  f"flex_attention's, {b['bound_ms'] / b['device_ms']:.1%} "
                  "of its bound")
        del q, k, v
    return held


#: gemma2-2b's attention time split apart, at the train step's S and its
#: local layers' mask (causal, window 4,096, bf16, D 256): the kernels as
#: the model calls them (8 query heads over 4 kv heads, softcap 50), the
#: same inputs without the softcap, and the softcap at twice the heads
#: (16 over 8, 752 forward blocks where 376 leave the last wave thin)
SPLIT_CASES = (("as called", 8, 4, 50.0), ("no softcap", 8, 4, 0.0),
               ("BH 16 over 8", 16, 8, 50.0))


def flash_split(power: str, cases=SPLIT_CASES, s: int = TRAIN_SEQ,
                d: int = 256, kind: str = "local", window: int = 4096,
                causal: bool = True) -> list:
    """The bf16 flash forward and backward at each of `cases` (label, BH,
    kv heads, softcap) on unscaled random inputs: each direction's
    device time (``time_ms(queued=True)``) beside its bound, the
    forward's kv shares (the backward's launches apart: phase 12's
    profiled step).  Prints a line a case; returns the measurements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    pairs = int(ref.attention_mask(s, causal, kind, window, dev).sum())
    out = []
    for label, bh, bh_kv, cap in cases:
        q, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (bh, bh_kv, bh_kv))
        kw = dict(causal=causal, kind=kind, window=window, softcap=cap)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        do = torch.randn((bh, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
        fwd = time_ms(lambda: flash_attention(q, k, v, **kw), queued=True)
        bwd = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, **kw),
                      queued=True)
        fb, _ = flash_bound(bh, bh_kv, s, d, q.dtype, pairs)
        bb, _ = flash_bwd_bound(bh, bh_kv, s, d, q.dtype, pairs)
        m = {"case": label, "shape": [bh, bh_kv, s, d], **kw,
             "device_ms": fwd, "bound_ms": fb, "bwd_device_ms": bwd,
             "bwd_bound_ms": bb,
             "kv_shares": kv_shares("wgmma", bh, s, d, d, kw)}
        print(f"phase12 (i) split {label}: BH={bh} G={bh // bh_kv} S={s} "
              f"D={d} {kw} bfloat16: forward device {fwd:.4f} ms, "
              f"{fb / fwd:.1%} of its bound {fb:.5f} ms, kv shares "
              f"{m['kv_shares']}; backward device {bwd:.4f} ms, "
              f"{bb / bwd:.1%} of its bound {bb:.5f} ms; {power}")
        out.append(m)
        del q, k, v, o, lse, do
    return out


def phase12_training() -> dict:
    """Phase 12's parts in order: (a)-(f) each of PHASE12_ARCHS trained
    (``train_full_width``, PHASE12_STEPS steps, gemma2-2b's and
    qwen1.5-110b's one more step profiled); (g) hubert-xlarge through
    ``train_loop``; (h) gemma2-2b's period's gradients against the plain
    versions; (i) the flash kernel at the shapes of (a)-(f) that no
    earlier phase holds, and gemma2-2b's attention time split apart
    (``flash_split``).  Returns the launches by run, (i)'s holds and the
    split."""
    t0 = time.perf_counter()
    power = card()
    runs = {arch: train_full_width(arch, f"phase 12 ({letter})",
                                   PHASE12_STEPS, arch in PHASE12_PROFILED)
            for letter, arch in zip("abcdef", PHASE12_ARCHS)}
    t_g = time.perf_counter()
    runs["train_loop " + AUDIO_ARCH] = phase12g_train_loop()
    t_h = time.perf_counter()
    _free_models("phase12 (h)")
    runs[GEMMA_ARCH + " period grads"] = phase8_period_grads(GEMMA_ARCH, 2)
    t_i = time.perf_counter()
    held = phase12i_flash_shapes()
    split = flash_split(power)
    print(f"phase12 total {time.perf_counter() - t0:.1f} s ((a)-(f) "
          f"{t_g - t0:.1f} s, (g) {t_h - t_g:.1f} s, (h) "
          f"{t_i - t_h:.1f} s, (i) {time.perf_counter() - t_i:.1f} s); "
          f"{power}")
    return runs, held, split


def train_lm_counts() -> dict:
    """The LM kernels' launch counts (``lm_counts``), the attention
    backward's, in all and by path, and the AdamW kernels'."""
    from repro_torch.kernels.adamw import adamw_update, grad_norm
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    counts = dict(lm_counts(),
                  flash_attention_bwd=flash_attention_bwd.launches,
                  adamw_update=adamw_update.launches,
                  grad_norm=grad_norm.launches)
    for p, n in flash_attention_bwd.launches_by_path.items():
        counts[f"flash_attention_bwd.{p}"] = n
    return counts


def phase13_train_lm(fwd: dict, bwd: dict) -> dict:
    """The twin of the ~100M training example (``launch/train_lm.py``) on
    the card at its default size, through ``train_lm.run`` as its command
    line runs it, the step captured in a CUDA graph at its first call and
    replayed after: TRAIN_LM_STEPS steps with a checkpoint every half
    into a temporary directory, the kernels' launches exact
    (``CaptureCounts``; each step 20 attention forwards under remat and
    10 backwards, all on the 3xTF32 kernels, none on the CUDA cores); a
    second run resumed from the half-way checkpoint (captured anew on the
    restored state), its losses within rtol TRAIN_LM_TOL of the straight
    run's; the straight run again from the seed through the eager step,
    its losses and final state's per-leaf checksums bitwise the graphed
    run's; TRAIN_LM_PLAIN_STEPS steps from the same seed through the
    plain versions, each loss within TRAIN_LM_TOL of the kernels' run's;
    step time graphed and eager (median of steps 2 on), tokens/s, peak
    memory and the losses; one more step captured and one replayed under
    the profiler, beside what the CUDA-core kernels
    would take at this shape for the step's launches (`fwd` and `bwd`:
    phase 4's and phase 8's measurements at the example's attention
    shape).  Returns the straight run's launches."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data.pipeline import ByteCorpus
    from repro_torch.distributed import make_train_step
    from repro_torch.launch import train_lm
    from repro_torch.launch.train import build_state, put_batch
    t0 = time.perf_counter()
    power = card()
    _free_models("phase13")
    cfg = train_lm.config()
    bh, g, s, d = TRAIN_LM_ATTN
    shape = train_lm.shape_of(False)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.window, cfg.dtype,
           cfg.attn_softcap, shape.global_batch, shape.seq_len)
          == (10, 768, bh // shape.global_batch, bh // g // shape.global_batch,
              d, 3072, 256, TRAIN_LM_KW["window"], "float32",
              TRAIN_LM_KW["softcap"], 8, s),
          f"phase 13: the twin's config {cfg} at {shape} is not the "
          "example's")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 13: f32 matrix products would run in TF32")
    n, fwd_layers, _ = _layer_counts(cfg)
    T, half = TRAIN_LM_STEPS, TRAIN_LM_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        straight, resumed = (os.path.join(tmp, x) for x in ("a", "b"))
        times = []
        torch.cuda.reset_peak_memory_stats()
        reset_lm_counts()
        t_run = time.perf_counter()
        with CaptureCounts(train_lm_counts) as cc:
            state, losses = train_lm.run(
                train_lm.parse(["--steps", str(T), "--ckpt-dir", straight]),
                save_every=half, times=times)
        wall = time.perf_counter() - t_run
        check(len(cc.marks) == 1, f"phase 13: {len(cc.marks)} captures")
        counts = cc.launched([T - 1])
        peak = torch.cuda.max_memory_allocated() / 2**30
        reserved = torch.cuda.max_memory_reserved() / 2**30
        one = {key: 0 for key in counts}
        one.update({"flash_attention": fwd_layers["attention"],
                    "flash_attention.tf32": fwd_layers["attention"],
                    "flash_attention_bwd": n["attention"],
                    "flash_attention_bwd.tf32": n["attention"],
                    **update_launches(state["params"], 1)})
        want = {key: c * T for key, c in one.items()}
        (warm, captured), = cc.per_capture()
        check(warm == captured == one, f"phase 13: launches counted at the "
              f"warm-up step {warm} and at the capture {captured}, a "
              f"step's {one}")
        sums = state_checksums(state)
        step_ms = statistics.median(times[1:]) * 1e3
        print(f"phase13 train_lm: {cfg.n_layers} layers of d {cfg.d_model}, "
              f"{cfg.param_count():,} parameters, f32, B "
              f"{shape.global_batch}, S {shape.seq_len}, {T} steps with a "
              f"checkpoint every {half} in {wall:.1f} s: step "
              f"{step_ms:.1f} ms (median of steps 2-{T}; first "
              f"{times[0] * 1e3:.1f} ms) = "
              f"{shape.global_batch * shape.seq_len / step_ms * 1e3:.1f} "
              f"tokens/s, peak memory {peak:.3f} GiB ({reserved:.3f} GiB "
              f"reserved); losses {[round(x, 4) for x in losses]}; "
              f"launches {counts} (a warm-up step, a capture and {T - 1} "
              "replays)")
        check(counts == want, f"phase 13: launches {counts}, expected "
              f"{want}")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"phase 13: losses {losses}")
        # the resumed run: the straight run's half-way checkpoint alone,
        # the step captured on the restored state
        name = f"step_{half:09d}"
        shutil.copytree(os.path.join(straight, name),
                        os.path.join(resumed, name))
        with CaptureCounts(train_lm_counts) as cc_again:
            _state, again = train_lm.run(
                train_lm.parse(["--steps", str(T), "--ckpt-dir", resumed]),
                save_every=half)
        del _state
        check(len(cc_again.marks) == 1 and cc_again.launched(
            [T - half - 1]) == {k: c * (T - half) for k, c in one.items()},
            f"phase 13: the resumed run's launches {cc_again.per_capture()}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(again, losses[half:]))
        print(f"phase13 resumed from step {half}: losses "
              f"{[round(x, 4) for x in again]}, worst relative difference "
              f"from the straight run {worst:.3g} (limit {TRAIN_LM_TOL})")
        check(len(again) == T - half and worst <= TRAIN_LM_TOL,
              f"phase 13: resumed losses {again} against {losses[half:]}")
    # the straight run again from the seed through the eager step: its
    # losses and final state bitwise the captured step's
    opt_cfg = train_lm.opt_config(T)
    corpus = ByteCorpus()
    eager = make_train_step(cfg, None, shape, opt_cfg=opt_cfg, remat=True,
                            device="cuda", graph=False)
    e_state = build_state(cfg, opt_cfg, 0, "cuda")
    e_losses, e_times = [], []
    for i in range(T):
        t_step = time.perf_counter()
        batch = put_batch(corpus.batch(i, shape.global_batch, shape.seq_len),
                          "cuda")
        e_state, m = eager.fn(e_state, batch)
        e_losses.append(float(m["loss"]))
        e_times.append(time.perf_counter() - t_step)
    same = (e_losses == losses, state_checksums(e_state) == sums)
    del e_state, eager
    eager_ms = statistics.median(e_times[1:]) * 1e3
    print(f"phase13 graphed against eager from the seed, {T} steps: losses "
          f"{'bitwise' if same[0] else 'differ'}, the final state's "
          f"{len(sums)} leaves' checksums "
          f"{'bitwise' if same[1] else 'differ'}; step graphed "
          f"{step_ms:.1f} ms, eager {eager_ms:.1f} ms "
          f"({eager_ms / step_ms:.2f}x; the step's loop as train_loop "
          f"times it, batch copy and loss read included)")
    check(all(same), f"phase 13: graphed losses {losses}, eager "
          f"{e_losses}; checksums equal {same[1]}")
    # the first steps again through the plain versions, from the same seed
    # and batches
    plain_state = build_state(cfg, opt_cfg, 0, "cuda")
    plain = make_train_step(cfg, None, shape, opt_cfg=opt_cfg, remat=True,
                            device="cuda", use_kernel=False)
    n0 = train_lm_counts()
    plain_losses = []
    for i in range(TRAIN_LM_PLAIN_STEPS):
        batch = put_batch(corpus.batch(i, shape.global_batch, shape.seq_len),
                          "cuda")
        plain_state, m = plain.fn(plain_state, batch)
        plain_losses.append(float(m["loss"]))
    del plain_state
    check(train_lm_counts() == n0, "phase 13: the plain steps launched a "
          "kernel")
    diff = max(abs(a - b) for a, b in zip(losses, plain_losses))
    print(f"phase13 kernels against plain, steps 1-{TRAIN_LM_PLAIN_STEPS}: "
          f"losses {losses[:TRAIN_LM_PLAIN_STEPS]} and {plain_losses}, "
          f"largest difference {diff:.3g} (limit {TRAIN_LM_TOL})")
    check(diff <= TRAIN_LM_TOL, f"phase 13: kernels' losses "
          f"{losses[:TRAIN_LM_PLAIN_STEPS]}, plain {plain_losses}")
    # one more step captured and one replayed under the profiler, and the
    # CUDA-core kernels at this shape for the step's launches (the route
    # f32 with a softcap took before)
    bundle = make_train_step(cfg, None, shape, opt_cfg=opt_cfg, remat=True,
                             device="cuda")
    state, _m = bundle.fn(state, put_batch(
        corpus.batch(T, shape.global_batch, shape.seq_len), "cuda"))
    batch = put_batch(corpus.batch(T + 1, shape.global_batch, shape.seq_len),
                      "cuda")
    state, prof = profile_train_step(bundle, state, batch, phase="phase13")
    print(f"phase13 graph: step graphed {step_ms:.1f} ms, eager "
          f"{eager_ms:.1f} ms, capture {bundle.fn.capture_ms:.1f} ms, pool "
          f"{bundle.fn.pool_bytes} bytes, peak {peak:.3f} GiB allocated "
          f"({reserved:.3f} GiB reserved)" + (
              f"; profiled step busy {prof['busy_ms']:.2f} ms, idle share "
              f"{prof['idle']:.4f}" if prof else "") + f"; {power}")
    bundle.fn.close()
    del state, bundle
    # one f32 product at the MLP's shape (B S x d by d x d_ff), timed on
    # the device: the rate the step's matrix products can run at
    x = torch.randn((shape.global_batch * shape.seq_len, cfg.d_model),
                    device="cuda")
    w = torch.randn((cfg.d_model, cfg.d_ff), device="cuda")
    mm_ms = time_ms(lambda: x @ w, queued=True)
    print(f"phase13 one f32 matmul ({x.shape[0]}, {cfg.d_model}) x "
          f"({cfg.d_model}, {cfg.d_ff}): {mm_ms:.4f} ms on the device, "
          f"{2 * x.numel() * cfg.d_ff / mm_ms / 1e9:.1f} TFLOP/s")
    kernels_ms = (fwd["device_ms"] * fwd_layers["attention"]
                  + bwd["device_ms"] * n["attention"])
    simt_ms = (fwd["simt_device_ms"] * fwd_layers["attention"]
               + bwd["simt_device_ms"] * n["attention"])
    print(f"phase13 attention a step at the kernels' phase 4 and 8 device "
          f"times: {kernels_ms:.2f} ms ({fwd_layers['attention']} forwards "
          f"x {fwd['device_ms']:.4f} + {n['attention']} backwards x "
          f"{bwd['device_ms']:.4f}); on the CUDA-core kernels, the parent's "
          f"route: {simt_ms:.2f} ms ({fwd['simt_device_ms']:.4f} and "
          f"{bwd['simt_device_ms']:.4f} ms a launch)")
    print(f"phase13 total {time.perf_counter() - t0:.1f} s; {power}")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: mamba2-2.7b in f32 at its published width and depth
# ---------------------------------------------------------------------------

#: phase 14 (a): the full model's loss and gradient leaves through the
#: kernels against the plain versions, f32 compute: the loss relative,
#: each leaf relative in norm
SSM_F32_LOSS_RTOL = 1e-5
SSM_F32_LEAF_TOL = 1e-3
#: phase 14 (c): train steps of the f32 model
SSM_F32_STEPS = 4
#: phase 14 (d): prompts served; last-position logits within this of the
#: largest |logit| and each layer's final state within it in norm of the
#: plain run's
SSM_F32_PROMPTS = (512, 3001)
SSM_F32_SERVE_TOL = 1e-3


def ssm_f32_config():
    """mamba2-2.7b at its published width and depth, computed in f32, as
    ``examples/train_lm.py`` builds its f32 config (``dtype="float32"``)."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH).replace(dtype="float32")
    n_heads = cfg.ssd.n_heads(cfg.d_model)
    check((cfg.n_layers, cfg.d_model, n_heads, cfg.ssd.head_dim,
           cfg.ssd.d_state, cfg.ssd.n_groups, cfg.vocab_size, cfg.dtype)
          == (64, 2560, 80, 64, 128, 1, 50280, "float32"),
          f"phase 14: {SSM_ARCH} in f32 is not at its published width")
    return cfg


def phase14a_model_grads(cfg) -> dict:
    """(a) one forward and backward of the whole f32 model (B TRAIN_BATCH,
    S TRAIN_SEQ, remat, TokenPipeline seed 0, f32 weights from seed 1)
    through the kernels and through the plain versions: the loss within
    SSM_F32_LOSS_RTOL relative, every gradient leaf within
    SSM_F32_LEAF_TOL in norm (the worst printed as a share of it), none
    zero through the kernels where the plain one is not, and the
    kernels' launches exact, all on the 3xTF32 path.  Returns the
    kernels' launches."""
    import gc
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import put_batch
    from repro_torch.models import model as model_lib
    from repro_torch.models import steps as steps_lib
    from repro_torch.optim.adamw import leaves_with_path
    _free_models("phase14 (a)")
    n, fwd, _ = _layer_counts(cfg)
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    named = leaves_with_path(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    shape = InputShape("phase14", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = put_batch(TokenPipeline(cfg, shape, seed=0).batch(0), "cuda")
    want = {k: 0 for k in train_counts()}
    want.update({"ssd_scan": fwd["ssm"], "ssd_scan.tf32": fwd["ssm"],
                 "ssd_scan_bwd": n["ssm"], "ssd_scan_bwd.tf32": n["ssm"]})
    grads, losses, launches = [], [], {}
    for use_kernel in (True, False):
        n0 = train_counts()
        t0 = time.perf_counter()
        loss, _ = steps_lib.loss_fn(cfg, params, batch, remat=True,
                                    use_kernel=use_kernel)
        grads.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        losses.append(float(loss.detach()))
        d = {k: c - n0[k] for k, c in train_counts().items()}
        print(f"phase14 (a) use_kernel={use_kernel}: loss {losses[-1]:.7f},"
              f" forward and backward {time.perf_counter() - t0:.2f} s, "
              f"launches {d}")
        check(d == (want if use_kernel else {k: 0 for k in d}),
              f"phase 14 (a) use_kernel={use_kernel}: launches {d}")
        if use_kernel:
            launches = d
    errs, lost = [], []
    for (path, _), gk, gp in zip(named, *grads):
        name = "/".join(p.strip("[]'") for p in path)
        errs.append((name, float((gk - gp).norm()
                                 / gp.norm().clamp_min(1e-30))))
        if not bool(gk.any()) and bool(gp.any()):
            lost.append(name)
    worst_name, worst = max(errs, key=lambda e: e[1])
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"phase14 (a) {SSM_ARCH} f32, {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in leaves):,} parameters, B {TRAIN_BATCH} "
          f"S {TRAIN_SEQ}: loss kernels {losses[0]:.7f}, plain "
          f"{losses[1]:.7f} (relative {rel:.3e}, limit {SSM_F32_LOSS_RTOL}); "
          f"worst leaf {worst_name} {worst:.3e} in norm, "
          f"{worst / SSM_F32_LEAF_TOL:.4f} of the {SSM_F32_LEAF_TOL} limit; "
          f"by leaf kind, the worst over layers: " + "; ".join(
              f"{kind} {max(e for nm, e in errs if nm.endswith(kind)):.2e}"
              for kind in sorted({nm.split('/')[-1] for nm, _ in errs})))
    print(f"phase14 (a) leaves zero through the kernels but not through the "
          f"plain versions: {lost or 'none'}")
    check(not lost, f"phase 14 (a): gradients lost through the kernels: "
          f"{lost}")
    check(rel <= SSM_F32_LOSS_RTOL, f"phase 14 (a): losses {losses}")
    check(worst <= SSM_F32_LEAF_TOL, f"phase 14 (a): {worst_name} differs "
          f"by {worst} in norm")
    del params, named, leaves, grads
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _f64_prefill(cfg, params, prompt, max_len: int):
    """The last-position logits and the SSM layers' final states of a
    prefill of `prompt` through the plain versions in float64 (the
    witness where the f32 runs differ by more than SSM_F32_SERVE_TOL)."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import _map
    p64 = _map(lambda t: t.double(), params)
    toks = torch.as_tensor(prompt[None].astype(np.int64), device="cuda")
    logits, cache = model_lib.prefill(cfg.replace(dtype="float64"), p64,
                                      {"tokens": toks}, max_len,
                                      use_kernel=False)
    del p64
    return logits[0].cpu(), [c["h"][0].cpu() for c in cache if "h" in c]


def phase14d_serve(cfg) -> dict:
    """(d) the f32 model served: one ServingEngine instance (SERVE_SLOTS
    slots, caches of SERVE_MAX_LEN) prefills two prompts of each of
    SSM_F32_PROMPTS and decodes SERVE_MAX_NEW greedy tokens through its
    captured step, with the kernels (64 3xTF32 SSD launches a prefill)
    and through the plain versions (eagerly).  The last-position logits
    within SSM_F32_SERVE_TOL of the largest |logit| of the plain run's,
    and each layer's final state within it in norm; where that fails, both
    runs against a float64 plain run, the kernels' no farther from it than
    WITNESS_RATIO times the plain f32 run's.  A captured decode step held
    against the eager one for SERVE_MAX_NEW greedy steps, the logits
    bitwise equal.  Returns the kernels' run's launches."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Request, ServingEngine
    _free_models("phase14 (d)")
    n_ssm = cfg.n_layers
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SSM_F32_PROMPTS for _ in range(2)]
    warm = ServingEngine(cfg, params, slots=1, max_len=SERVE_MAX_LEN)
    warm.scale_up(1)
    warm.submit(Request(-1, prompts[0][:256].copy(), 2))
    warm.drain()
    del warm
    done, rec_k, launches, wall, peak, dec = _serve(cfg, params, prompts,
                                                    True)
    want = {k: 0 for k in launches}
    want.update({"ssd_scan": n_ssm * len(prompts),
                 "ssd_scan.tf32": n_ssm * len(prompts)})
    n_steps = sum(rec_k.decode_steps.values())
    prefill_ms = [1e3 * (r.t_first_token - r.t_admit) for r in done]
    print(f"phase14 (d) kernels' drain {wall:.3f} s: prefills "
          + ", ".join(f"{len(r.prompt)} tokens {ms:.1f} ms"
                      for r, ms in zip(done, prefill_ms))
          + f"; {dec.replays} replays for {n_steps} decode steps; peak "
          f"memory {peak / 2**30:.3f} GiB; launches {launches}")
    check(launches == want, f"phase 14 (d): launches {launches}, expected "
          f"{want}")
    check(dec.graph is not None and dec.replays == n_steps,
          f"phase 14 (d): {dec.replays} replays for {n_steps} decode steps")
    check(all(len(r.tokens) == SERVE_MAX_NEW for r in done),
          "phase 14 (d): not every request finished")
    dec.close()
    del dec
    hold = hold_served_graph("phase14 (d)", cfg, params, prompts,
                             SERVE_MAX_LEN, SERVE_MAX_NEW)
    check(hold["max_logit_diff"] == 0, f"phase 14 (d): the captured decode "
          f"step's logits differ from the eager step's by "
          f"{hold['max_logit_diff']}")
    _, rec_p, launches_p, wall_p, _, dec_p = _serve(cfg, params, prompts,
                                                    False)
    del dec_p
    check(not any(launches_p.values()), f"phase 14 (d): the plain run "
          f"launched {launches_p}")
    worst = {"logits": 0.0, "states": 0.0}
    for i, prompt in enumerate(prompts):
        lk, lp = rec_k.logits[i], rec_p.logits[i]
        err = float((lk - lp).abs().max()) / float(lp.abs().max())
        h_err = max(float((hk - hp).norm() / hp.norm())
                    for hk, hp in zip(rec_k.states[i], rec_p.states[i]))
        worst["logits"] = max(worst["logits"], err)
        worst["states"] = max(worst["states"], h_err)
        same = int(lk.argmax()) == int(lp.argmax())
        print(f"phase14 (d) prefill {len(prompt)}: logits max_abs_err "
              f"{err:.3e} of max |logit| (limit {SSM_F32_SERVE_TOL}), "
              f"states {h_err:.3e} in norm at worst over {n_ssm} layers; "
              f"first token same={same}")
        check(bool(torch.isfinite(lk).all()), f"phase 14 (d) prefill "
              f"{len(prompt)}: logits not finite")
        if err <= SSM_F32_SERVE_TOL and h_err <= SSM_F32_SERVE_TOL:
            continue
        l64, h64 = _f64_prefill(cfg, params, prompt, SERVE_MAX_LEN)
        dist = lambda a, b: float((a.double() - b).norm() / b.norm())
        kl, pl = dist(lk, l64), dist(lp, l64)
        kh = max(dist(a, b) for a, b in zip(rec_k.states[i], h64))
        ph = max(dist(a, b) for a, b in zip(rec_p.states[i], h64))
        print(f"phase14 (d) prefill {len(prompt)} against float64: logits "
              f"kernels {kl:.3e}, plain {pl:.3e}; states kernels {kh:.3e}, "
              f"plain {ph:.3e} (limit {WITNESS_RATIO} times the plain run's)")
        check(kl <= WITNESS_RATIO * pl and kh <= WITNESS_RATIO * ph,
              f"phase 14 (d) prefill {len(prompt)}: the kernels' run is "
              f"farther from float64 than the plain run")
    print(f"phase14 (d) plain drain {wall_p:.3f} s; worst logits "
          f"{worst['logits']:.3e}, worst state {worst['states']:.3e}")
    del params
    return launches


def phase14_mamba_f32() -> dict:
    """Phase 14: mamba2-2.7b at its published width and depth computed in
    f32, every SSD scan and backward on the 3xTF32 kernels: (a) the whole
    model's gradients through the kernels against the plain versions;
    (b) one SSM layer's at S PERIOD_SEQ (``phase8_period_grads``, f32,
    F32_GRAD_TOL); (c) SSM_F32_STEPS train steps on f32 weights and
    moments (``train_full_width``: launches exact, 128 forwards and 64
    backwards a step on "tf32", step time, tokens/s, peak memory, one
    step profiled with the SSD kernels' device time beside the rest); (d)
    the model served (``phase14d_serve``).  Returns the launches by
    part."""
    import torch
    t0 = time.perf_counter()
    power = card()
    cfg = ssm_f32_config()
    # the f32 model's matrix products in full f32, as the reference's
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 14: f32 matrix products would run in TF32")
    out = {"a": phase14a_model_grads(cfg)}
    t_b = time.perf_counter()
    _free_models("phase14 (b)")
    out["b"] = phase8_period_grads(SSM_ARCH, f32=True, phase="phase14 (b)")
    t_c = time.perf_counter()
    out["c"] = train_full_width(SSM_ARCH, "phase 14 (c)", SSM_F32_STEPS,
                                f32=True)
    t_d = time.perf_counter()
    out["d"] = phase14d_serve(cfg)
    print(f"phase14 total {time.perf_counter() - t0:.1f} s ((a) "
          f"{t_b - t0:.1f} s, (b) {t_c - t_b:.1f} s, (c) {t_d - t_c:.1f} s, "
          f"(d) {time.perf_counter() - t_d:.1f} s); {power}")
    return out


#: one tree's training phases, each timed (``ab_training``); the phase
#: functions of every tree since the train step was captured
_TRAINING_PHASES = """
import os, sys, time
root = os.getcwd()
sys.path[:0] = [os.path.join(root, "src"), root]
import chip_smoke as cs
print("tree", root, cs.card(), flush=True)
cs.phase0_build()
times = {}
for name, run in (("8", cs.phase8_training), ("12", cs.phase12_training),
                  ("13", lambda: cs.phase13_train_lm(
                      *({"device_ms": 0.0, "simt_device_ms": 0.0},) * 2)),
                  ("14", cs.phase14_mamba_f32)):
    t = time.perf_counter()
    run()
    times[name] = round(time.perf_counter() - t, 1)
print("AB", root, times, flush=True)
"""


def ab_training(roots) -> None:
    """A train-step A/B in one call: for each tree in `roots` in turn (a
    repository root, e.g. the parent unpacked by ``git archive`` under
    ``build/``), in a process of its own, that tree's ``chip_smoke``
    builds its kernels and runs its phases 8, 12, 13 and 14, each timed
    (line "AB <root> {phase: s}").  Phase 13 is handed zero kernel times
    (its attention rows are phase 4's)."""
    for root in roots:
        subprocess.run([sys.executable, "-c", _TRAINING_PHASES],
                       cwd=os.path.abspath(root), check=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.core as core
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    procs = {}
    try:
        procs = start_dryruns()
        phase0_build()
        t_wait = time.perf_counter()
        warm_flex()
        dryruns = finish_dryruns(procs)
        print(f"phase0 waited {time.perf_counter() - t_wait:.2f} s after "
              "the build for phase 10 (e)'s dry runs (flex_attention's "
              "compiles at the training example's shape included)")
        scn = core.make_scenario("burst-storm", **SCENARIO)
        world = core.scenario_world(scn, engine="numpy")
        phase1_kernels(world)
        phase2_drain(world)
        rec, l_b, l_c = phase3_main_path()
        kernels = main_path_kernels(rec, l_b, l_c)
        device_share("b", "cuda", "host")
        device_share("c", "cuda", "device")
        lm = phase4_lm_kernels()
        serve_launches = phase5_serving(
            lm["flash_attention"]["simt_device_ms"],
            lm["rglru_scan"]["simt_device_ms"])
        ssm_launches = phase6_ssm_serving()
        moe_launches = phase6b_moe_serving()
        platform_launches = phase7_platform()
        train, train_launches = phase8_training()
        serve_driver_launches, gemma, cluster = phase9_serving_entry_points()
        mesh = phase10_mesh(dryruns)
        other = phase11_other_archs()
        trained, held12, split12 = phase12_training()
        lm_launches = phase13_train_lm(lm["flash_attention train_lm"],
                                       train["flash_attention_bwd train_lm"])
        ssm_f32 = phase14_mamba_f32()
        for name in ("flash_attention", "rglru_scan", "ssd_scan"):
            m = lm[name]
            launches = (ssm_launches if name == "ssd_scan"
                        else serve_launches)[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": CSRC + SOURCES[name], "replaces": REPLACES[name],
                "launches": launches,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "shape": m["shape"]})
            # the path that ran and, for the redesigned kernels, the
            # first kernel they replace on it, timed in this run
            for key in ("path", "simt_ms", "simt_device_ms"):
                if key in m:
                    kernels[-1][key] = m[key]
        # the backward kernels: no TPU kernel has a backward (XLA
        # differentiates the reference's jnp paths); `replaces` names the
        # Pallas kernel whose function they differentiate; launches are
        # phase 8 (b)'s, of the architecture that runs each
        for name, source, fwd, jnp_path, arch in (
                ("flash_attention_bwd", "flash_attention_bwd_wgmma.cu",
                 "flash_attention",
                 "src/repro/models/attention.py:118 blockwise_attention",
                 TRAIN_ARCH),
                ("rglru_scan_bwd", "rglru_scan.cu", "rglru_scan",
                 "src/repro/models/rglru.py:69 lru_scan", TRAIN_ARCH),
                ("ssd_scan_bwd", "ssd_scan_bwd_wgmma.cu", "ssd_scan",
                 "src/repro/models/ssd.py:63 ssd_chunked", SSM_ARCH)):
            m = train[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": CSRC + source, "replaces": REPLACES[fwd],
                "differentiates": jnp_path + " (XLA autodiff)",
                "launches": train_launches[arch][name],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "shape": m["shape"]})
            # the path that ran and, for the redesigned backwards, the
            # first kernel's times on the same inputs
            for key in ("path", "simt_ms", "simt_device_ms"):
                if key in m:
                    kernels[-1][key] = m[key]
            if "simt_ms" in m:
                kernels[-1]["simt_source"] = CSRC + (
                    "ssd_scan_bwd.cu" if name == "ssd_scan_bwd"
                    else "flash_attention_bwd.cu")
        # the f32 SSD scan and its backward at mamba2-2.7b's shape (phases
        # 4 and 8 (a)): the 3xTF32 kernels, the first designs (the CUDA
        # cores) timed beside them, their launches phase 14's by part
        for name, m, source in (
                ("ssd_scan", lm["ssd_scan f32"], "ssd_scan_tf32.cu"),
                ("ssd_scan_bwd", train["ssd_scan_bwd f32"],
                 "ssd_scan_bwd_tf32.cu")):
            by_part = {part: c.get(f"{name}.tf32", 0)
                       for part, c in ssm_f32.items()}
            next(k for k in kernels if k["name"] == name)["f32"] = {
                "source": CSRC + source,
                "simt_source": CSRC + source.replace("_tf32", ""),
                "launches": sum(by_part.values()),
                "launches_by_part": by_part,
                **{key: m[key] for key in (
                    "path", "shape", "max_abs_err", "ms", "device_ms",
                    "simt_ms", "simt_device_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")},
                "main_path": "mamba2-2.7b in f32 (phase 14)"}
            print(f"{name} f32 path={m['path']} ({CSRC}{source}) at "
                  f"{m['shape']}: kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms, {m['bound_ms'] / m['device_ms']:.3f}"
                  f" of the bound), first design {m['simt_ms']:.4f} ms "
                  f"(device {m['simt_device_ms']:.4f} ms, "
                  f"{m['simt_device_ms'] / m['device_ms']:.2f}x the new), "
                  f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.5f} "
                  f"ms ({m['bound_by']}), max_abs_err {m['max_abs_err']:.3g}"
                  f"; phase 14 launches {by_part}")
        # the AdamW update and the gradient norm (phase 8 (a)): no TPU
        # kernel, XLA fuses the reference's update and norm inside its
        # jitted step; times at recurrentgemma-2b's embedding table (f32
        # state), deepseek-v2-236b's expert leaf (bf16) under "bf16";
        # launches phase 8 (b)'s recurrentgemma-2b run's, by phase beside
        # (phase 10 (b)'s and 12's added below with the other kernels')
        f32_leaf, bf16_leaf = (train["adamw"][leaf[0]]
                               for leaf in ADAMW_LEAVES)
        for i, (name, fused) in enumerate((
                ("adamw_update", "src/repro/optim/adamw.py:71 update"),
                ("grad_norm", "src/repro/optim/adamw.py:58 global_norm"))):
            m = f32_leaf[i]
            kernels.append({
                "name": name, "route": "cuda", "source": CSRC + "adamw.cu",
                "replaces": f"none: XLA fuses {fused} inside the jitted "
                            "step (src/repro/distributed/steps.py:254)",
                "launches": train_launches[TRAIN_ARCH][name],
                "launches_by_phase": {
                    "8b": {arch: train_launches[arch][name]
                           for arch in TRAIN_ARCHS + (MOE_ARCH,)},
                    "8e": train_launches["policy_fit"][name],
                    "13": lm_launches[name]},
                **{key: m[key] for key in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "plain_device_ms", "bound_ms", "bound_by", "library",
                    "library_ms", "library_device_ms", "shape")},
                **{key: m[key] for key in ("held", "nohold_ms",
                                           "nohold_device_ms") if key in m},
                "bf16": bf16_leaf[i]})
        # the 3xTF32 kernels' softcapped instantiations at the ~100M
        # training example's shape (phases 4 and 8 (a)), their launches
        # phase 13's straight run's
        for name, m, source, counted in (
                ("flash_attention f32 softcap", lm["flash_attention train_lm"],
                 "flash_attention_tf32.cu", "flash_attention.tf32"),
                ("flash_attention_bwd f32 softcap",
                 train["flash_attention_bwd train_lm"],
                 "flash_attention_bwd_tf32.cu", "flash_attention_bwd.tf32")):
            kernels.append({
                "name": name, "route": "cuda", "source": CSRC + source,
                "replaces": REPLACES["flash_attention"],
                "launches": lm_launches[counted],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"],
                "library_device_ms": m["library_device_ms"],
                "library": m["library"], "shape": m["shape"],
                "path": m["path"], "simt_ms": m["simt_ms"],
                "simt_device_ms": m["simt_device_ms"],
                "simt_source": CSRC + ("flash_attention_bwd.cu"
                                       if "bwd" in name
                                       else "flash_attention.cu"),
                "main_path": "launch/train_lm.py (phase 13)"})
            if "bwd" in name:
                kernels[-1]["differentiates"] = (
                    "src/repro/models/attention.py:118 blockwise_attention "
                    "(XLA autodiff)")
        # launches of each forest kernel in phase 7's runs (b2 and c
        # launch the forest kernel, b3 the sweep)
        for k in kernels[:2]:
            k["platform_launches"] = {
                label: l[k["name"]] for label, l in platform_launches.items()
                if label != "b1"}
        # phase 9: the serve driver's forest launches (a); gemma2-2b's
        # flash launches (b) and its shapes' times; the serve_cluster
        # twin's launches by load (c)
        kernels[0]["serve_launches"] = serve_driver_launches
        for k in kernels:
            if k["name"] in ("flash_attention", "ssd_scan"):
                k["cluster_launches"] = {
                    load: {p: n for p, n in l.items()
                           if p.split(".")[0] == k["name"]}
                    for load, l in cluster.items()}
        next(k for k in kernels if k["name"] == "flash_attention")[
            "gemma2"] = {
            "source": CSRC + SOURCES["flash_attention"],
            "launches": gemma["launches"]["flash_attention"],
            "launches_by_path": {
                p: gemma["launches"][f"flash_attention.{p}"]
                for p in ("wgmma", "tf32", "simt")},
            "times": [{key: m[key] for key in (
                "path", "shape", "kind", "window", "softcap", "max_abs_err",
                "ms", "device_ms", "simt_ms", "simt_device_ms", "plain_ms",
                "library", "library_ms", "library_device_ms", "bound_ms",
                "bound_by")}
                for m in gemma["times"]]}
        # phase 10: the launches of the mesh path (a 1x1 NCCL mesh):
        # recurrentgemma-2b's mesh train steps (b), gemma2-2b's mesh
        # prefill and decode by prompt length (c), deepseek-v2's by hints
        # (f)
        for k in kernels:
            if k["name"] in mesh["train"] and mesh["train"][k["name"]]:
                k["mesh_launches"] = {"train": mesh["train"][k["name"]]}
        mesh_flash = next(k for k in kernels
                          if k["name"] == "flash_attention"
                          ).setdefault("mesh_launches", {})
        mesh_flash["serve"] = {
            S: c["flash_attention"] for S, c in mesh["serve"]["mesh"].items()}
        # deepseek-v2's mesh prefill and decode by hints and prompt
        # length (f), all on the wgmma kernel at MLA's shape
        mesh_flash["moe_dshard"] = {
            h: {S: c["flash_attention.wgmma"] for S, c in by_s.items()}
            for h, by_s in mesh["moe"].items() if h != "one-device"}
        # the f32 attention backward (3xTF32), which no model launches,
        # rides in the attention backward's entry under "f32"
        f32b = train["flash_attention_bwd f32"]
        flash_bwd = next(k for k in kernels
                         if k["name"] == "flash_attention_bwd")
        flash_bwd["f32"] = {
            "source": CSRC + "flash_attention_bwd_tf32.cu",
            "launches": sum(train_launches[arch]["flash_attention_bwd.tf32"]
                            for arch in TRAIN_ARCHS),
            **{key: f32b[key] for key in (
                "path", "shape", "max_abs_err", "ms", "device_ms", "simt_ms",
                "simt_device_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")}}
        # the MLA shape's backward (deepseek-v2-236b trained in phase 8
        # (b)): the wgmma kernel at D 192, Dv 128, launches phase 8 (b)'s
        # deepseek run by path; the 3xTF32 kernel's f32 beside, its
        # launches phase 8 (c3)'s; the CUDA-core kernel timed beside both
        mla_b, mla_b32 = (train["flash_attention_bwd mla"],
                          train["flash_attention_bwd mla f32"])
        moe_counts, c3 = train_launches[MOE_ARCH], train_launches["c3"]
        keys = ("path", "shape", "max_abs_err", "ms", "device_ms", "simt_ms",
                "simt_device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")
        flash_bwd["mla"] = {
            "source": CSRC + "flash_attention_bwd_wgmma.cu",
            "launches": moe_counts["flash_attention_bwd"],
            "launches_by_path": {
                p: moe_counts[f"flash_attention_bwd.{p}"]
                for p in ("wgmma", "tf32", "simt")},
            **{key: mla_b.get(key) for key in keys},
            "f32": {"source": CSRC + "flash_attention_bwd_tf32.cu",
                    "simt_source": CSRC + "flash_attention_bwd.cu",
                    "launches": c3["flash_attention_bwd.tf32"],
                    **{key: mla_b32.get(key) for key in keys}}}
        for label, m in (("bf16", mla_b), ("f32", mla_b32)):
            print(f"flash_attention_bwd mla {label} path={m['path']} at "
                  f"{m['shape']}: kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms), CUDA-core kernel "
                  f"{m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} "
                  f"ms), plain {m['plain_ms']:.4f} ms, sdpa backward "
                  f"{m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f} ms), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}), max_abs_err "
                  f"{m['max_abs_err']:.3g}")
        print(f"flash_attention_bwd f32 path={f32b['path']} "
              f"({CSRC}flash_attention_bwd_tf32.cu) at {f32b['shape']}: "
              f"kernel {f32b['ms']:.4f} ms (device {f32b['device_ms']:.4f} "
              f"ms), first kernel {f32b['simt_ms']:.4f} ms (device "
              f"{f32b['simt_device_ms']:.4f} ms), plain "
              f"{f32b['plain_ms']:.4f} ms, sdpa backward "
              f"{f32b['library_ms']:.4f} ms, bound {f32b['bound_ms']:.5f} ms "
              f"({f32b['bound_by']}), max_abs_err {f32b['max_abs_err']:.3g}")
        # the MLA shape (deepseek-v2-236b's prefill, phase 6 (b)): the
        # wgmma kernel at D 192, Dv 128, launches phase 6 (b)'s kernels
        # run; the 3xTF32 kernel's f32 beside, its launches phase 8
        # (c3)'s; the CUDA-core kernel timed beside both
        flash = next(k for k in kernels if k["name"] == "flash_attention")
        keys = ("path", "shape", "max_abs_err", "ms", "device_ms", "simt_ms",
                "simt_device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by")
        mla, mla32 = lm["flash_attention mla"], lm["flash_attention mla f32"]
        flash["mla"] = {
            "source": CSRC + SOURCES["flash_attention"],
            "launches": moe_launches["flash_attention"],
            **{key: mla.get(key) for key in keys},
            "f32": {"source": CSRC + SOURCES["flash_attention f32"],
                    "simt_source": CSRC + "flash_attention.cu",
                    "launches": c3["flash_attention.tf32"],
                    **{key: mla32.get(key) for key in keys},
                    "cuda_core_bound_ms": mla32["cuda_core_bound_ms"]}}
        for label, m in (("bf16", mla), ("f32", mla32)):
            print(f"flash_attention mla {label} path={m['path']} at "
                  f"{m['shape']}: kernel {m['ms']:.4f} ms (device "
                  f"{m['device_ms']:.4f} ms), CUDA-core kernel "
                  f"{m['simt_ms']:.4f} ms (device {m['simt_device_ms']:.4f} "
                  f"ms), plain {m['plain_ms']:.4f} ms, sdpa "
                  f"{m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f} ms), bound "
                  f"{m['bound_ms']:.5f} ms ({m['bound_by']}), max_abs_err "
                  f"{m['max_abs_err']:.3g}")
        # phase 11: the other six architectures' flash launches by path,
        # (a)-(d) in their kernels' drains of 4 (llama4: 6) prefills, (e)
        # in two prefills, (f) in two forwards; their first layers'
        # backward launches (g); the kernel at their shapes (h)
        paths = ("wgmma", "tf32", "simt")
        flash["phase11"] = {
            "launches_by_path": {
                arch: {p: n[f"flash_attention.{p}"] for p in paths}
                for arch, n in other["served"].items()},
            "times": other["times"]}
        flash_bwd["phase11"] = {
            "launches_by_path": {
                arch: {p: n[f"flash_attention_bwd.{p}"] for p in paths}
                for arch, n in other["grads"].items()},
            "times": other["bwd_times"]}
        # phase 12 (i): the kernel held at the train step's shapes that
        # no earlier phase holds, both directions
        shared = ("arch", "shape", "causal", "kind", "window", "softcap")
        flash["phase12_held"] = [
            {key: h[key] for key in h if not key.startswith("bwd_")}
            for h in held12]
        flash_bwd["phase12_held"] = [
            {key[4:] if key.startswith("bwd_") else key: h[key]
             for key in h if key.startswith("bwd_") or key in shared}
            for h in held12]
        # gemma2-2b's attention split apart (phase 12 (i))
        flash["phase12_split"] = [
            {key: m[key] for key in m if not key.startswith("bwd_")}
            for m in split12]
        flash_bwd["phase12_split"] = [
            {key[4:] if key.startswith("bwd_") else key: m[key]
             for key in m if key.startswith("bwd_") or key in shared
             or key == "case"} for m in split12]
        # phase 12: each kernel's launches by run, beside phase 8's
        for k in kernels:
            name = k["name"]
            if any(key.split(".")[0] == name for key in trained[GEMMA_ARCH]):
                k["phase12_launches"] = {
                    run: {key: c for key, c in counts.items()
                          if key.split(".")[0] == name}
                    for run, counts in trained.items()}
        # the (D, Dv) instantiations of each tensor-core path, forward and
        # backward alike (bf16 also at hubert-xlarge's 80, padded)
        from repro_torch.kernels.flash_attention import (
            TF32_HEAD_DIMS, WGMMA_BF16_HEAD_DIMS, WGMMA_QK_V_DIMS)
        for k in (flash, flash_bwd):
            k["head_dims"] = {
                "wgmma": [[d, d] for d in WGMMA_BF16_HEAD_DIMS]
                + [list(p) for p in WGMMA_QK_V_DIMS],
                "tf32": [[d, d] for d in TF32_HEAD_DIMS]
                + [list(p) for p in WGMMA_QK_V_DIMS]}
        f32 = lm["flash_attention f32"]
        flash["f32"] = {
            "source": CSRC + SOURCES["flash_attention f32"],
            **{key: f32[key] for key in (
                "path", "shape", "max_abs_err", "ms", "device_ms",
                "simt_ms", "simt_device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms", "bound_by",
                "cuda_core_bound_ms")}}
        print(f"flash_attention f32 path={f32['path']} "
              f"({CSRC}{SOURCES['flash_attention f32']}) at {f32['shape']}: "
              f"kernel {f32['ms']:.4f} ms (device {f32['device_ms']:.4f} ms), "
              f"CUDA-core kernel {f32['simt_ms']:.4f} ms (device "
              f"{f32['simt_device_ms']:.4f} ms), plain {f32['plain_ms']:.4f} "
              f"ms, sdpa {f32['library_ms']:.4f} ms (device "
              f"{f32['library_device_ms']:.4f} ms), bound "
              f"{f32['bound_ms']:.5f} ms ({f32['bound_by']}, TF32 rate; "
              f"{f32['cuda_core_bound_ms']:.5f} ms at 67 TFLOP/s), "
              f"max_abs_err {f32['max_abs_err']:.3g}")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
