"""Drive the PyTorch port (``tpu_on_k8s_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each reporting on lines of its own:

1. environment and build: the card's name and power limit, TF32 off, every
   kernel source under ``tpu_on_k8s_torch/ops/csrc/`` built with nvcc (one
   process per source, all at once), with each kernel's registers and
   spills, and the count of wgmma instructions (``HGMMA`` for bf16,
   ``IGMMA`` for int8) that ``cuobjdump --dump-sass`` finds in each Hopper
   kernel, with the highest register it names: the bf16 forward, dq and
   dk/dv kernels and the int8 GEMM must have some; the quantizer's loops
   are counted for its issue figure (phase 5);
2. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes: the flash forward and the two
   backward kernels (dq, dk/dv) within stated tolerances, all three also
   at the Hopper kernels' tile edges (L 63-65, 127-129, 255, 2047; D 64
   and 128; GQA rep 1, 2, 4; valid_len 129; segments crossing a 128-row
   tile; and all of it at D 256, whose forward and dk/dv tiles hold 64
   keys) and launched twice on the same inputs, which must agree bit for
   bit; the kernels at head dim 256 (google/gemma-7b's 16 heads x 256) in
   bf16 and fp32, causal, with valid_len, segments and GQA; the flash
   kernels at head dims 16, 32, 80, 96 and 192 (zero-padded to 64, 128 or
   256 in the wrappers), forward and backward; the int8 GEMM (also
   against ``torch._int_mm``) at the training shapes and at its tile edges
   (M 1-8192, N 129/257, K 16-2064, and a K that takes the byte-wise
   path); the ``torch._int_mm`` route at M 1, 16 and 17, K 40, N 129
   (zero-padded; the refusal of the unpadded call is printed); the
   quantize and the dequantize kernels bit for bit, also at their edges
   (rows of zeros, one non-zero, subnormal and huge values, C 1, 3 and
   17, 125 KB rows, a misaligned base); the row scales of ``_quant_rows``
   and of the serving quantizer on the card equal to the CPU's (a true
   division by 127);
3. serving: ``generate`` at ``llama2_7b`` width (32 layers, bf16, random
   weights from a seed) answers a greedy batch-4 request and a sampled
   batch-1 request; the flash forward's launch count shows that each prefill
   went through it; the prefill logits with the kernel agree with the same
   model run on the plain attention;
3b. W8A16 serving: ``quantize_serving_tree(stochastic=True)`` turns the
   same weights into int8 (one quantize launch per matrix), ``generate``
   serves the greedy request from that tree, and its prefill logits are
   held against an fp32 model of its own dequantized weights; then
   ``quantize_pytree`` / ``dequantize_pytree`` round-trip the ``llama2_1b``
   fp32 masters;
3c. int8 serving: ``mlp_int8`` + ``head_int8`` greedy decoding at batch 4
   on the ``int8_impl="xla"`` route (``torch._int_mm`` at decode's M) and
   on the int8 GEMM kernel, with equal tokens;
3d. the three CLIs (``generate``, ``train_llama``, ``serve``) with their
   own defaults, and ``serve --gateway`` and ``serve --replicas 2
   --rollout-demo`` (the serving plane's), every request served; then ``train_llama --config tiny --checkpoint-dir D
   --eval-data F --eval-every 6`` on ``cuda`` (evaluations at steps 6 and
   12, step 12 saved), and ``generate --checkpoint-dir D`` and ``serve
   --checkpoint-dir D``, whose greedy tokens equal those of the restored
   parameters held in memory;
3e. continuous batching: ``ContinuousBatchingEngine`` on phase 3's weights,
   8 slots of 2048 positions, greedy, serves 24 seeded requests (prompts
   64-1000 tokens, 16-64 new, two submitted per step) five times: (a)
   dense, (b) paged, (c) with chunked prefill, (d) with a registered
   384-token prefix that 8 requests carry, (e) dense again. In (c), (d)
   and (e) every flash call is held against the plain attention on the
   engine's own q, k, v, within the bf16 tolerance. (b)'s and (e)'s tokens
   equal (a)'s; every token of (a), (c) and (d) is within tau
   (``TAU_MULT`` x phase 3's kernel-vs-plain logit distance) of the
   maximum of a teacher-forced, no-cache forward on the plain attention,
   and at least ``EXACT_MIN`` of them its argmax, while a control run with
   a planted fault (each decode step's K/V written one position late)
   must break both limits in every request; the flash forward launches
   once a layer per prefill from an empty cache, as the engine counts
   them (none for a later chunk or a suffix); every request is complete;
   (b)'s pool drains with its null page zero. The decode step at full
   occupancy, prefill times by bucket (CUDA events), tokens/s and the time
   to first token of (a) and (b) are printed;
3f. disaggregated prefill on 3e's traffic and weights, three engines sharing
   the parameter tensors: a monolithic dense engine M (prefill_chunk 256,
   one batch-1 admission at a time), a prefill engine P driven only through
   ``start_prefill`` → ``advance`` → ``handoff`` (the prefix's carriers
   suffix-only) and a paged decode engine D adopting every handoff through
   ``submit_kv``, its prefix imported from P. Every handoff verifies, and
   fails with one payload byte flipped; D's tokens equal M's for every
   request; D runs no prefill and no ``flash_fwd``, P one a layer per fresh
   prefill; a second run of M moves 4 requests to D mid-decode
   (``export_kv``, ``abort``, ``submit_kv``) with every output unchanged; a
   descendant prefix imported over its 256-token ancestor aliases the
   ancestor's pages and serves as D's own registered prefix; the serving
   and paged-KV metrics, read through ``exposition()``, count what each
   engine saw, and D's pool drains with page 0 zero; every flash call of M,
   of its second run and of the prefix section is held against the plain
   attention within 3e's bf16 tolerance, and each bucket x batch that P's
   timed prefills launch must be among them. The handoff bytes, the
   export, seal, verify and adoption times of each request and both
   engines' decode step at occupancy 8 are printed;
3g. speculative decoding on 3e's weights and the first SPEC_REQUESTS (12)
   of its requests, ``spec_k`` 4, 8 slots x 2048: (a) dense, the target
   itself as the draft; (b) dense, its first 4 layers (``truncated_draft``,
   the target's own tensors) as the draft, 3e's prefix registered
   (mirrored through the draft) and carried by the 4 of them that carry it
   in 3e; (c) (b) on the paged pool; (d) (b) under
   ``spec_draft_crash(at_round=2)``; (e) ``speculative_generate`` at batch
   1 (prompt 512, 16 new) with both drafts; (f) phase 3b's W8A16 tree as
   the target of (b)'s bf16 draft, 4 requests. Every request completes;
   (a) accepts proposals, (b) rolls some back; (c)'s tokens equal (b)'s,
   its pool drains with page 0 zero; (d) crashes on round 2 and finishes
   on the plain step; every token of (a), (b), (d), (e) within tau of a
   teacher-forced maximum (3e's gate; (f) of its own W8 model and of the
   fp32 model of its dequantized weights, 3b's reference), a control
   run of (b) with its verify's K/V written one position late caught in
   every request; flash_fwd launches once a layer per fresh target prefill
   and once a draft layer per fresh draft seed (none for a suffix seed);
   every flash call of (b) within 3e's bf16 tolerance of the plain
   attention. A round's draft and verify times, acceptance, tokens a
   round, tokens/s and TTFT beside 3e (a)'s, and (e)'s ms a token beside
   plain ``generate``'s are printed;
3h. the int8 KV cache (``cache_int8``) on phase 3's weights: (a)
   ``generate`` batch 4 x 512 -> 64 greedy off the int8 cache, its prefill
   through the flash forward on the unquantized K, V (one launch a layer,
   each call held against the plain attention), its prefill logits equal
   to the bf16 cache's bit for bit, one decode step teacher-forced off
   both caches within rel 0.05 of the bf16 cache's logits (the reference's
   own oracle); (b) the cache quantizer of the K and V that (a)'s bf16
   prefill wrote, on the card and on the CPU: int8 values and scales bit
   for bit, and equal to the int8 prefill's stored leaves; (c) 3e's first
   8 requests with its prefix, dense and paged (160 x 128): paged tokens
   equal dense, every token within 3e's tau gate, the pool drained with
   page 0 zero, ``kv_bytes_per_chip`` beside bf16's; (d) a handoff at
   bucket 1024 (69,206,016 B) from the dense engine to the paged one,
   verified, a flipped scale byte caught, its tokens equal to the dense
   engine's own batch-1 admission of the request. The decode step at
   occupancy 8 beside 3e (a)'s, the handoff's export, seal, verify and
   adoption times and ``generate``'s times off the int8 cache are
   printed;
7. the serving plane (``tpu_on_k8s_torch/serve/``; run after 3h, on
   phase 3's weights, with 3e's traffic and engines of 8 slots x 2048):
   (a) ``ServingGateway`` over one engine, tenants at weights 1:2:4, a
   queue bound of 16: the 24 requests submitted at once (8 shed with a
   typed queue-full ``Rejected`` and submitted again once the queue
   drains), one cancelled mid-decode, one expiring mid-decode (both
   leave their slots on the step that finalizes them), under
   ``engine_crash_mid_decode(at_steps=(5,))`` (the survivors replayed);
   (b) ``ServingFleet``, two replicas, prefix bucket 16, rolled to a
   second tree ``v2`` (``torch.Generator`` seed 1) with ``max_surge=1``
   once half the requests are in, under
   ``replica_crash_mid_decode("replica-1")``; (c) ``DisaggFleet``, a
   dense prefill replica and a paged decode replica, 3e's prefix in its
   ``FleetPrefixStore``, under ``disagg_handoff_chaos`` (one handoff lost,
   one corrupted: the corrupted one fails ``verify`` and both are
   replayed); (d) ``ModelPool`` over one engine with v1 and v2, the
   requests alternating between the two lanes, 4 admissions a turn, under
   ``model_swap_failure(at_swap=2)`` (the refused swap leaves v1 live and
   is retried). (b) serves the first 16 of 3e's requests (cut from 24 to
   make room for phase 19), (c) the first 8 and (d) the first 12
   (PLANE_CUT; cut from all 24 to make room for phase 16): 3f
   already hands off every one of the 24 through the same seal, verify
   and adoption, 8 still take (c)'s lost and corrupted handoffs and a
   prefix-store hit, and 12 still take (d)'s three swaps with the refused
   one and its retry (8 take one swap). Every request ends as planned (DONE, or the cancel and
   the expiry of (a)), none lost; (a)'s streamed tokens end in each
   result; ``flash_fwd`` launches once a layer per fresh prefill on every
   path (replays, the fleet's auto-registered heads and the rollout's new
   replicas included) and never on (c)'s decode replica; every DONE
   request's tokens within 3e's tau gate against the model that served
   it (v1 or v2). The gateway's host time a step, queue wait, TTFT,
   tokens/s beside 3e (a)'s, the fleet's reroutes, prefix hits and
   rollout phases, the handoffs' bytes, seal and verify times and the
   store's counters, and the pool's swaps, ``replace_params`` times and
   decision ledger are printed;
4. training: a gradient gate (the first step's gradients of the kernel
   model against plain-attention models in bf16 and fp32), then ``Trainer``
   at ``llama2_1b`` (16 layers, full width, fp32 masters, bf16 compute,
   flash attention, MLP remat) takes 8 steps on one fixed batch 4 x 2048,
   after a count of the dense products the MLP's backward re-runs (0);
   the launch counts show that every layer's forward and backward went
   through the kernels, and the loss is finite and falls;
4b. int8 training: the same model with every int8 flag (``mlp_int8``,
   ``mlp_fused_gateup``, ``head_int8``, ``attn_int8``, ``int8_impl=
   "pallas"``): its first step's loss and gradients equal those of the same
   model with the int8 GEMM's plain version patched in, with 113 int8 GEMM
   launches a step (the recompute of remat "mlp" stops before w_down's
   product, as the reference's XLA does), then 8 steps;
4c. the training loop: ``train_step_flops`` on the card within 0.3-1.7 of
   6·N·T; ``Trainer.fit`` at ``llama2_1b`` (remat mlp, flash, batch 4 x
   2048) over 12 distinct seeded batches through ``device_prefetch``,
   ``log_every`` 4: a fault-free run with 3 host syncs and, under
   ``torch.cuda.set_sync_debug_mode("warn")``, no other synchronizing call;
   a fresh run under ``train_preemption(7)`` with ``checkpoint_every`` 4,
   ``max_to_keep`` 1, that stops preempted after step 6 with steps 4 and 6
   saved (only the checkpoint writer's thread syncs besides the windows);
   a third, fresh ``TrainState`` restored from it runs steps 7-12, and the
   stitched losses and the final weights equal the fault-free run's bit
   for bit; 16 launches of each flash kernel a step. The loop's step time
   beside phase 4's bare step, the ``mfu`` gauge, the checkpoint's bytes,
   the snapshot's stall and one async save's write from its enqueue to
   its last byte (on the preempted run's manager, whose saves allocated
   its buffers; a second, blocking save was cut for phase 17) and the
   restore are printed;
4d. the remat policies at ``llama2_1b``: one forward and backward each
   under full, mlp, dots and dots_kernels, whose loss and gradients equal
   the no-remat step's bit for bit, with 32, 16, 32 and 16 flash forward
   launches, and (mlp, dots, dots_kernels) the no-remat backward's count
   of dense products; each policy's peak memory and step time printed;
5. times on the card, each beside the card's name and power limit; the
   library columns (SDPA's forward and backward, ``torch._int_mm`` with
   its epilogue, ``torch.mul``) as the kernels are timed, 20 calls in a
   CUDA graph (``time_ms``), SDPA's backward through autograd captured on
   the stream its forward ran on (``sdpa_backward``);
5b. head dim 256 (``phase 5b`` is timed): (a) the three kernels at
   google/gemma-7b's attention width (B 4, H 16, L 2048, D 256, causal)
   against their plain twins and timed beside them, SDPA and their bound
   (the JSON's ``d256``); (b) a model made here at that head dim
   (llama2_7b's widths over 16 heads, 2 layers, seeded random weights):
   ``generate`` 2 x 512 -> 16 with one flash forward a layer, its prefill
   logits within ``LOGITS_NOISE_MULT`` of the plain-attention bf16
   model's distance from the fp32 model; (c) one forward and backward on
   2 x 1024 tokens, each kernel launched once a layer, every gradient
   within ``GRAD_NOISE_MULT`` of the plain bf16 model's distance from fp32
   (phase 4's gate);
6. the GPT-2 family at ``gpt2_small`` width (12 layers, d_model 768, 12
   heads of 64, d_ff 3072, vocab 50257, 1024 learned positions, LayerNorm,
   tanh-GELU, tied head): (a) a biased tree from seed 0 exported with
   ``to_hf_gpt2`` and restored with ``config_from_hf_gpt2`` (a namespace of
   ``GPT2Config``'s documented defaults: no ``transformers`` here) and
   ``params_from_hf_gpt2``, bit for bit; (b) ``generate`` batch 4 x 512 ->
   64 greedy in bf16: 12 ``flash_fwd`` launches for its fresh prefill, the
   prefill logits within ``LOGITS_NOISE_MULT`` of the bf16 noise floor;
   (c) the engine, ``max_len`` pinned to the table's 1024 (256 pinned up,
   2048 refused), 8 slots, 24 requests from numpy seed 5 (prompts 64-896,
   16-64 new), a 128-token prefix carried by 8, dense and paged: equal
   tokens, every flash call of the paged run within 3e's bf16 tolerance of
   the plain attention, the pool drained; every token within tau
   (``GPT2_TAU_MULT`` x (b)'s max|kernel - plain|) of a teacher-forced
   maximum, a planted fault (the decode steps' position table shifted one
   row) caught in every request and 3e's K/V-late fault rejected as a
   whole; (d) ``gpt2_small`` (bias-free) with flash and remat full, batch
   8 x 1024: 24 / 12 / 12 flash launches a step (12 / 12 / 12 under remat
   mlp), the step-1 gradients within ``GRAD_NOISE_MULT`` of the kernels'
   plain twins' bf16 model's distance from fp32 (the plain attention's and
   SDPA's printed beside it), 8 steps through ``Trainer.fit`` with a
   falling loss; (e) ``train_gpt2`` at its defaults (8 x 512), 2 steps
   saved, then 2 more resumed from them as generation 1; (f) the three
   flash kernels timed at D 64, GPT-2's training and prefill shapes,
   beside their plain twins, SDPA and their bounds.

8. mesh-sharded training at ``llama2_1b`` (run last) on a world of
   one rank made by ``train/distributed.py``'s ``initialize`` over NCCL
   (torchrun's variables, a loopback port; the group destroyed after):
   (a) ``Trainer(model, rules=flagship_partition_rules(),
   mesh=create_mesh(MeshConfig()))`` (FSDP2 over the card), 8 steps on
   phase 4's batch, loss and grad norm equal to phase 4's bit for bit, 16
   launches of each flash kernel a step, step ms and peak memory beside
   phase 4's; (c) its state through one asynchronous collective DCP save
   (the host's stall and the write's time; a second, blocking save of the
   same 10.6 GB was cut to make room for phase 15), restored onto the
   unsharded layout, every tensor bit-equal, and the next step from it
   equal to the live mesh's in loss and norm (its restore back onto the
   mesh was cut to make room for phase 19), bytes and save / restore
   times printed; (d) ``TrainLoop`` with a ``ReshardNotice`` before step 5 (the
   flagship rules to model-only rules on the same mesh: n_moved and
   bytes_moved printed, 0 at world 1), the losses equal (a)'s; (b) every
   int8 flag on the mesh, 113 ``int8_matmul`` a step, phase 4b's losses
   bit for bit; (f) ``train_step_flops`` of
   (a)'s trainer on the mesh (the per-device count) equal to phase 4c's
   meshless count exactly, and a ``TrainLoop`` on the mesh fed with it
   sets a finite ``mfu`` gauge;
9. mesh-sharded serving at ``llama2_7b`` width (after phase 8, on phase 3's
   weights made again from their seed) on a world of one rank made by
   ``initialize`` over NCCL, with the serving command channel's gloo group
   (the group destroyed after): (a) phase 3e's first MESH_REQUESTS
   requests, each cut to at most MESH_NEW new tokens, through
   ``ContinuousBatchingEngine(mesh=serving_mesh(model=1))`` and through
   the meshless engine, dense and paged: the mesh
   engine's models hold the parameter tensors themselves, its tokens equal
   the meshless engine's token for token, with the same flash launches
   (one a layer per fresh prefill); decode step ms and peak memory of both
   beside 3e (a)'s step, and the host time of a command header, an
   all-reduce and the logits' all-gather on the one-rank groups; (b) phase
   3b's W8A16 tree (the quantize kernel
   again) on the mesh and meshless, tokens equal; (c) a mid-decode export
   from the mesh engine adopted meshless and one the other way: both
   verify, each checksum equal to the other engine's export at the same
   step, the continuations equal the uninterrupted tokens; (d)
   ``shard_report()`` and the ``ShardMetrics`` gauges: per-chip bytes equal
   the totals, the mesh-axis gauges all 1; (e) a two-replica
   ``ServingFleet`` rolled from meshless to mesh replicas under load with
   zero loss (a world-1 mesh has no non-trivial axis, so the mesh
   signature and ``reshard_rollouts`` stay as they were); (f) phase 3c's
   int8-recipe config with every serving-time int8 and fused flag
   (``mlp_int8``, ``head_int8``, ``mlp_fused_gateup``, ``fused_qkv``,
   ``int8_impl="pallas"``) on phase 3's weights fused, the same requests
   on the mesh and meshless: tokens equal, ``int8_matmul`` launches equal
   in both engines and above 0 (``mesh_serve_int8``), the row-parallel
   ``w_down``'s absmax all-reduce-max and fp32 sum run on the one-rank
   group, step ms and peak memory beside (a)'s;
10. the vision models and BERT (after phase 9; ``phase 10`` is timed):
   (a) ResNet-50 in fp32 with every BatchNorm's scale and bias from a seed,
   a train-mode forward of 8 images on the card (TF32 off) against the CPU
   within ``RESNET_GATE_TOL`` of the logits' largest; then in bf16,
   ``ClassifierTrainer`` with adam(1e-3) on one card, 10 steps on one
   batch of 256 x 224 x 224 x 3 NHWC images from numpy (or the largest of
   192, 128, 64 that fits, printed as a finding): images/s (median of
   steps 2-10, each ending in a synchronize), step ms and peak memory, one
   more step's kernels under ``torch.profiler``, each counted to the op
   that launched it (BatchNorm's forward and backward, the convolutions,
   the optimizer and the rest by op and by kernel: ``profiled_step``),
   beside ``BASELINE.json``'s v5e 2513.5 images/s as a reading, not a
   target; every BatchNorm buffer moved and finite; the last loss below
   the first; (b) ``python -m tpu_on_k8s_torch.train_mnist`` and
   ``train_resnet --tiny`` at their defaults (50 steps, cuda), in process,
   finite; (c) BERT-base (attn xla, adamw) at 32 x 128, 6 steps: step ms,
   tokens/s and peak, step 0's loss within 1.0 of ln(30522); then
   ``train_bert`` at its defaults but ``--steps 10`` (BERT_CLI_STEPS);
   (d) BERT-base with attn flash and a
   padding mask, 8 x 512, each row's real length from numpy seed 6 in
   64-512: the real-position logits within ``LOGITS_NOISE_MULT`` of the
   xla bf16 model's distance from the fp32 model; one step's gradients,
   as one vector, within ``GRAD_NOISE_MULT`` of the xla bf16 model's, and
   the q/k/v projections' (what the kernels' gradients feed), as one
   vector, within ``GRAD_NOISE_MULT`` of the kernels' plain twins' (per
   tensor the ratios are printed: against xla they pass 2 in the last
   blocks, near-uniform random attention where dS rounds to bf16, as
   GPT-2's in phase 6 (d)); 12 flash forward launches in a forward
   and 12 / 12 / 12 in a training step; the three kernels at this shape
   (non-causal, padding segments, D 64) against their plain twins, twice
   launched bit for bit, and timed beside their plain twins, SDPA with
   the equivalent boolean mask and their bound over the data's kept
   pairs (the JSON's ``bert_padded_d64``); (e) the three kernels at a
   rank's heads over a model axis of 2 and 4 (H 6 and 3 of 12, laid out
   as a rank's projections make them, the same shape and segments)
   against their plain twins, the backward twice launched bit for bit;
   BERT-base (flash, the padding mask) on a world-1 NCCL mesh
   ``MeshConfig(model=1, seq=1)`` through ``Bert.tensor_parallel`` and
   ``split_sequence`` (which ``shard_model`` calls only over an axis > 1):
   logits within (d)'s bf16 noise and gradients within (d)'s xla distance
   of the meshless model's, 12 launches of each kernel;
11. sequence and pipeline parallelism (after phase 10; ``phase 11`` is
   timed). The card is one, so the ``seq`` and ``stage`` axes run at world
   1 and the ring's and Ulysses's per-rank bodies run over virtual chunks:
   (a) ``parallel/ring.py``'s bodies at llama2_1b's attention width (B 1,
   H 16, L 8192, D 128) in 4 chunks of 2048, each rank's body fed, through
   the rotate seam, the chunks it would receive (``ring_in_lockstep``),
   then the hand-written backward, causal and non-causal: the concatenated
   output within ``TOL`` of its row's largest against one flash call over
   the whole 8192 (``row_rel_err``; lse within ``TOL`` absolute), dq/dk/dv
   within ``BWD_REL_TOL`` of the largest against the whole-sequence
   backward, 10 forward, 10 dq and 10 dk/dv launches causal (4 diagonal, 6
   past) and 16 of each non-causal, the ring's forward + backward ms
   beside the whole-sequence kernels', the host's ms to enqueue the ring,
   and one ring under ``torch.profiler`` (device time by kernel group);
   (b) Ulysses's body over
   4 virtual head groups of 4 heads at that shape: each group's output and
   gradients equal the whole-head call's heads bit for bit; (c) llama2_1b
   on a world-1 NCCL mesh ``MeshConfig(seq=1)`` with ``attn_impl`` xla,
   ring, ulysses and flash, 2 steps each on phase 4's batch: ring and
   ulysses (a ring of one is the plain attention) equal xla bit for bit,
   flash 16 launches of each kernel a step; then ``train_llama.main``
   with ``--config tiny --attn ring --seq-axis 1 --steps 3`` in the
   process (its own process until phase 19, ~19 s); (d) ``gpipe`` over ``stage_mesh(1, 1)`` with llama2_1b's 16
   blocks (flash) stacked through ``torch.func.functional_call`` on 2 x
   2048 in 2 microbatches: the output within ``TOL`` of the sequential
   blocks' largest, each stacked leaf's gradient (and the input's) within
   ``GRAD_NOISE_MULT`` of the sequential bf16 run's distance from fp32,
   16 x 2 launches of each flash kernel; (e) the three kernels at the
   ring's chunk shape (B 1, H 16, L 2048, D 128, non-causal) against their
   plain twins (the output by ``row_rel_err``) and timed beside them, SDPA non-causal and their bound (the
   JSON's ``ring_chunk_d128``). It bypasses what one card cannot run: the
   P2P exchanges, the all-to-alls and the stage sends between cards.
12. MoE (after phase 11; ``phase 12`` is timed): llama2_1b's width with
   Mixtral-8x7B's routing, 8 experts and top 2 (``num_local_experts`` and
   ``num_experts_per_tok`` of mistralai/Mixtral-8x7B-v0.1), made in the
   script: (a) the engine, 16 layers bf16 with seeded random weights, 8
   slots x 2048, on the first ``MOE_REQUESTS`` of phase 3e's requests (16
   flash launches per fresh prefill, nothing else); each emitted token
   held by a teacher-forced gate against the plain attention, routed as
   the engine routed it (the prompt padded to its bucket, so its capacity
   is the engine's, then the emitted tokens at a capacity that drops
   nothing, as the one-token steps drop nothing), the gate's limits
   between that sound reading and a control whose engine drops each
   token's second expert, which must break both limits over its requests
   as a whole (``MOE_CONTROL_SHARE``); the share of routing decisions on
   which the kernel and plain-attention prefills agree; 4 decode steps
   with every slot busy under ``torch.profiler``; (b) training at
   ``MOE_TRAIN_LAYERS`` layers on phase 4's batch (4 x 2048, flash, aux
   weight ``MOE_AUX``): the first step's gradients by phase 4's
   noise-floor rule (remat full) with the routing pinned (the fp32 plain
   model's dispatch masks replayed in the kernel and plain bf16 models,
   each gate recomputed from the model's own router, so that the floor is
   bf16 rounding and not tokens routed apart) and a finite aux loss; the
   same under ``mlp_int8`` with ``int8_impl="pallas"``, whose plain side
   runs the int8 kernel's plain twin; one step (remat mlp) with 4
   launches of each flash kernel, then one under ``mlp_int8`` whose int8
   launches equal layers x 3 products x 8 experts x 2 (the MoE's
   checkpoint runs its products again);
   (c) the int8 kernel at one expert's product (M = 4 x 640 capacity rows,
   N 5632, K 2048) against its plain twin bit for bit, timed beside
   ``_int_mm`` with its epilogue and its bound (the JSON's
   ``moe_expert``); (d) world-1 NCCL meshes: ``MeshConfig(expert=1)``
   training one step equal to the meshless step bit for bit, and the
   engine on ``serving_mesh(1, 1, 1)`` equal to the meshless engine token
   for token; (e) one step on ``MeshConfig(seq=1)`` through
   ``Transformer.split_sequence`` (the seq-aware route, its slot counts
   all-gathered each round; attention gathered over ``seq``) equal to the
   meshless step bit for bit. The sums over a ``seq`` axis > 1 are held
   on the CPU over gloo (``tests/test_torch_moe.py``,
   ``tests/test_torch_vision_mesh.py``).
13. A TorchJob runs the port's trainer on the card (``phase 13`` is
   timed): (a) the job controller (``controller/torchjob.py``'s
   ``setup_torchjob_controller`` on an ``InMemoryCluster``) reconciles a
   ``TorchJob`` of one Master on a ``1x1`` ``GPUPolicy`` whose container
   runs ``python -m tpu_on_k8s_torch.train_llama --config llama2_1b
   --steps 2`` at ``TORCHJOB_BATCH`` x ``TORCHJOB_SEQ``; the pod's env
   must hold ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
   ``nvidia.com/gpu`` and no TPU name; the container's command runs as a
   subprocess, as a kubelet would, with exactly the pod's env on top of
   ``PATH`` and ``HOME``, so ``train/distributed.py::initialize`` joins
   NCCL at world 1 from that env and the CLI trains on a mesh over it (it
   takes the place of phase 8's former ``train_llama --config tiny`` run
   on a mesh); its exit code goes back through
   ``KubeletSim.terminate_pod`` and the job must reach ``Succeeded``
   (the times from submit to Running and to Succeeded are printed);
   (b) a job whose container exits 138 (user-retryable) once is recreated
   by the engine (a new pod uid, ``Restarting``) and succeeds on its
   second run; one whose container exits 1 fails the job (``PodFailed``).
   Every container here really runs, and any disagreement fails the run.
14. An elastic TorchJob driven by the card (``phase 14`` is timed): the
   job controller with an ``ElasticController`` and a ``CRRRestarter``, a
   ``NodeAgentLoop`` over a ``KubeletSim`` runtime (both on their own
   threads, as deployed) and an ``ElasticAutoscaler`` on a
   ``DecisionLedger``, all on an ``InMemoryCluster``, run an elastic
   worker-only ``TorchJob`` (one worker, ``1x8``, ``ElasticPolicy(1, 2)``)
   whose training is the port's ``Trainer`` at gpt2_small's full width and
   depth (flash, remat full, batch ``ELASTIC_BATCH`` x ``ELASTIC_SEQ``) in
   this process. (a) ``ELASTIC_STEPS`` steps on the card, each step's
   ``[elastic-metrics]`` line (``train_llama.StepTimer``'s, with the
   step's measured seconds) written into worker-0's log; one autoscaler
   tick must decide ``up`` 1 -> 2 with a ``landed`` ledger record, and the
   respec must give 2 workers on ``2x8`` at generation 2, worker-1 with
   ``RANK=1``, and worker-0 restarted in place through a CRR the node agent
   executed (same uid, world-size annotation 2, elastic-restarts 1). (b)
   worker-1 deleted: the finalizer holds it as a victim, the controller
   requests a checkpoint at generation 2, and ``aimaster.run`` saves the
   trainer's state on the card through ``CheckpointManager.save`` at that
   generation and acknowledges; the controller must drain the victim,
   respec to one host at generation 3 and restart worker-0 in place again.
   (c) The checkpoint restored into a fresh ``train_state_template`` on
   the card: every tensor bit-identical to the live state's, and one more
   step on each gives step 7 on the restored state and the same loss.
   The phase's flash launches (24/12/12 a step, 8 steps) are its path
   ``elastic``; the decision and ledger lines, request-to-ack seconds and
   the save and restore times and sizes are printed beside the card's
   line.

15. The serving control plane over gpt2_small replicas (``phase 15`` is
   timed): ``tests/test_autoscale.py``'s acceptance loop
   (``_drive_burst``) at gpt2_small's full width and depth (12 layers,
   d_model 768, vocab 50257, bf16, phase 6's tree from its torch seed) in
   ``fleet_burst``: a ``ServingFleet`` of replica engines (8 slots x 1024
   positions, one weight set on the card, each its own cache), a
   ``FleetAutoscaler`` attached to it with an ``AutoscaleMetrics`` on a
   fake clock (0.05 s a fleet step, a tick every second step, the loop's
   policy: min 1, max 4, target TTFT 0.3 s, max step 2, cooldowns 0.5 /
   1.5 s, flap guard 1.0 s), and on the same ``InMemoryCluster`` the
   ``InferenceService`` (``nvidia-h100-80gb``, ``1x8``, an ``slo`` block
   with a TTFT objective) reconciled by ``setup_inferenceservice_controller``
   on a ``Manager`` with a ``KubeletSim`` after every tick. The burst: 3-5
   requests a fleet step over steps 4-13 from numpy seed 0, prompts of phase
   6 (c)'s 64-896 tokens with 16-64 new, the tokens from a second seeded
   stream. (a) The reference's gates of ``test_burst_scales_up_then_down``
   (up, then back to 1, every transition on a legal host count, cooldowns
   and the flap guard between executed scales, no thrash, every request
   done, no ejection, every retired replica drained clean, ``status``
   desired 1 with "down", the decisions counted); after every tick the
   replica pods follow ``spec.replicas`` (live gangs, ``nvidia.com/gpu``
   8, the accelerator selector, no TPU name) and ``status.slo`` is the SLO
   engine's state; the decision log byte-identical to the same loop's at
   ``tiny`` on the CPU (with gpt2_small's vocabulary, so that both take the
   same prompts: the router hashes a prompt's first tokens); every greedy
   token within phase 6 (c)'s tau of a teacher-forced maximum, at least
   its exact share the argmax. (b) The same burst at seed 3 under
   ``autoscale_under_crash(replica="replica-1", crash_at=3,
   outage_at=(2, 3, 4))``: one ejection, ``stale_signal`` in the log, every
   request done or retry_exhausted, up and no thrash, its log byte-identical
   to its CPU twin's, its done requests through the same token gate. Not
   "back at 1": the first scale goes 1 -> 4 in one step before the crash,
   and the reference's loop then holds at 4 with 3 ready (it never shrinks
   a world that has not assembled, and nothing replaces an ejected replica
   outside a scale). Both runs' flash launches (one a layer a fresh
   prefill) are the path ``fleet_autoscale``; the transitions, fleet steps,
   wall seconds and host ms a fleet step are printed.

16. The capacity market over gpt2_small (``phase 16`` is timed), built by
   the port's entry: ``tpu_on_k8s_torch.main.Operator`` on the in-memory
   backend with ``--feature-gates JobCoordinator=true`` and
   ``--broker-capacity-chips 6``, a ``KubeletSim`` running every pod.
   (a) ``brokered_burst``: three consumers share 6 hosts (BROKER_* above
   give the arithmetic). Serving: phase 15's InferenceService, burst,
   policy and fake clock, its operator-built ``FleetAutoscaler`` attached
   to a ``ServingFleet`` of gpt2_small replicas in bf16 (phase 15's
   factory, phase 6's tree). Batch: a ``BatchLane`` registered with the
   operator's broker as a managed consumer and fed by
   ``BatchGatewayBridge`` into a ``ServingGateway`` over one more
   gpt2_small engine (fp32), 12 seeded items of 64-512 prompt tokens with
   16-32 new. Training: the elastic TorchJob ``train`` (4 hosts, floor 2)
   in tenant queue ``team-train`` beside ``eval`` in ``team-eval``,
   admitted by the operator's ``Coordinator`` (default quota and priority
   plugins) in the order smooth WRR gives, its pods carrying
   ``nvidia.com/gpu`` and ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
   ``MASTER_PORT`` and no TPU name; its ``ElasticAutoscaler`` bids and
   freezes at its max on worker-0's step lines. The gates: the broker's
   decision log climbs harvest (the batch lane) -> preempt (training, to
   no less than its floor) -> grant (serving), with no degrade (GPT-2's
   biased layers refuse the int8 variant) and no refusal; the refused
   scale-up burned no cooldown (the next up lands sooner than a cooldown
   would allow); the lane's ``intact()`` after every fleet step, its
   harvest cancels in-flight gateway requests through ``yield_excess``
   (the gateway reports them cancelled), the fill grants it again after
   the burst and every item completes with the tokens of a solo greedy
   ``generate`` of its prompt on the card; phase 15's serving gates and
   its teacher-forced token gate; the broker's, the fleet autoscaler's and
   the elastic autoscaler's decision logs byte-identical to the same
   driver's at ``tiny`` on the CPU. (b) ``broker_grant_crash``: the
   reference's ``broker_grant_under_crash("replica-1")`` case on two
   gpt2_small replicas: the stale-bid grant rejects the whole lane
   transition, one ejection, the next clearing fills the lane, every
   request done or retry_exhausted, a ``chaos#`` trigger on the ledger's
   conflict, exactly one sequence-numbered flight-recorder dump, and a
   Chrome trace with one complete event a finished span. The flash
   launches of (a) and (b) are the path ``broker``; the rungs, each
   consumer's hosts before and after, the yielded items, the fleet steps
   and host ms a fleet step are printed.

17. The load driver on the card (``phase 17`` is timed):
   ``tpu_on_k8s_torch.serve_load.main`` called in this process on
   ``cuda`` with the ``--bench`` flagship (``serve_load.bench_config``:
   ~350M parameters, 16 layers of 16 heads x 64 over 8 kv heads, flash
   attention, the int8-forward MLP on the ``torch._int_mm`` route, random
   bf16 weights from torch seed 0), as the reference's two serving stages
   run it. (a) The gateway under wall-clock arrivals (LOAD_TTFT_ARGV: 48
   seeded requests at 1.5 a step into 8 slots, after an off-trace warm-up
   drawn from the trace's rng): every request served, rejected, expired
   or cancelled, tokens > 0, TTFT and queue-wait p50 measured, and
   ``flash_fwd`` launched exactly 16 times a prefill the engine counts
   (``fresh_prefills``, warm-up included); TTFT and TPOT p50/p95/p99,
   queue wait and tokens/s printed. (b) The traced disaggregated fleet
   (LOAD_TRACE_ARGV, its ``--trace-out`` under the run's temporary
   directory): the monolithic control arm of 3 engines, then 1 prefill
   and 2 decode engines with a 128-token prefix store; the disaggregated
   arm accounts for all 48 requests, the port's ``obs/trace_report`` on
   the dump decomposes or marks every request (``decomposed + no_token``
   = 48) and names the request, queue, prefill, handoff and decode spans,
   and ``flash_fwd`` launches on both arms, 16 a fresh prefill. Each TTFT
   segment's p50/p95 and share and the residual are printed. Greedy tokens
   are not compared across the arms: bf16 does not keep them across batch
   shapes (phase 6 (c)); phases 3e-3g hold those engines' tokens. Both
   runs' flash launches are the path ``load``.
18. The digital twin priced by the card (``phase 18`` is timed): (a) phase
   15's replica engine (gpt2_small bf16, 8 slots x 1024 positions, on
   ``cuda``) measured three ways, each sample ended by a synchronize:
   three replica starts (the weights from the host to the card, the
   engine's set-up and its first step: what the cost model's
   ``compile_s`` prices, though the port compiles nothing), every engine
   step at full occupancy 8 (at least 32), and single-request prefills
   at 8 prompt lengths from 16 to 1000 (max_new_tokens 1, twice each after
   a warm pass); ``flash_fwd`` launched 12 times a fresh prefill, the path
   ``twin``. (b) The samples written as one measurement document (with
   the card's name and power limit) under the run's temporary directory
   and fitted by ``python -m tpu_on_k8s_torch.sim.calibrate DOC --strict``:
   exit 0, ``step_s``, ``prefill_cost`` and ``compile_s`` all fitted, the
   calibration document round-trips; printed beside the defaults. (c) The
   ``smoke`` preset on the fitted costs through the port's ``run_twin``,
   twice: the four artifacts byte-identical, the summary's accounting
   closed, ``fuzz_run.report_gate`` passing; the summary, the oracle's
   verdict kinds, the ``SimMetrics`` exposition and the speedup (virtual
   over wall, run A's ``time.perf_counter``) printed, the story not gated.
19. The drivers of the reference's ``tools/`` on the card (``phase 19`` is
   timed): (a) ``chaos_soak.run_all(1234)`` twice, its serve stage on
   gpt2_small (12 layers, d_model 768, vocab 50257) in fp32 with
   ``max_seq_len`` 64, torch seed 1, on ``cuda``: ``replaced`` 4, ``done``
   6, ``retry_exhausted_storm`` 2, ``steps`` 14, every DONE request's
   tokens equal to ``generate``'s (``oracle_exact=6``), the two event logs
   identical; a third run on the CPU at ``tiny`` without the operator stage
   (it touches no device) gives the card's serve and train lines but the
   train line's ``losses_crc`` (printed, with whether they agree); path
   ``chaos``. (b) ``reshard_soak.main(["--repeat", "2", "--ledger-out",
   ...])`` exits 0 with the reference's figures (``events_crc``
   ``23b9ae46``, both arms' pause and goodput, the wins); no world left,
   and then an NCCL world of one lays out and reduces a ``DTensor``;
   ``--bench`` on ``cuda`` with one card raises. (c) ``attn_micro`` at its
   default shape, its lines beside the card's name and power limit; the
   flash forward and its gradients on its inputs within phase 2's
   tolerances of the plain twins; path ``attn_micro``. (d)
   ``perf_sweep.run_variant`` on the runbook's control variant and on the
   same with ``i8impl=pallas``, SWEEP_STEPS timed steps each: finite rows,
   step ms, tok/s and MFU of 989 TFLOP/s printed, ``int8_matmul`` 3 a
   layer a step in the second and none in the first; path ``sweep``. (e)
   ``step_breakdown`` at ``int8=1 nu=bf16``, BREAKDOWN_STEPS calls a part:
   the four parts and their sum beside the full step; path ``breakdown``.
   (f) ``longcontext_proof.card_part`` (4 layers at d 1024, batch 2, L 4096
   and 4000): finite losses, step ms, tokens/s, the step's peak over the
   held bytes beside the naive score matrix, the ragged ratio; path
   ``longcontext``; then the three flash kernels at B 2, H 16 (k/v at 16
   and at 8 heads), D 64, L 4096 and 4000 against their plain twins within
   phase 2's tolerances and bit for bit on a second launch, and timed at
   the training path's heads beside SDPA and the bound (the ``kernels``
   line's ``longcontext`` rows). (g) ``driver_bench``: ResNet-50 at 256 for
   3 steps, ``bench_decode`` 8 x 128 -> 32, ``bench_continuous`` 16
   requests of 32 tokens (all served), ``bench_speculative`` 27 tokens
   self-drafted, ``bench_submit_to_first_step`` 5 jobs (5 samples); each
   JSON printed with the card's line; path ``driver_bench``.

Then one JSON line for the kernels, the card's line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import os
import sys
import tempfile
import time
import types
import warnings
from collections import Counter
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM dense peaks (NVIDIA data sheet), the denominators of bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# Stated tolerances of the forward kernel against its plain version: bf16
# outputs carry ~3 significant digits and the kernel rounds P to bf16 per K
# tile against a running max (the plain version against the final max); lse
# is fp32 from the same fp32 scores. fp32 differs only in summation order.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# Backward kernels, as max|kernel - plain| / max|plain| per gradient: bf16
# gradients keep 8 bits of mantissa (4e-3 of the largest value), and ds and
# p round to bf16 from fp32 values summed in another order; fp32 differs
# only in summation order.
BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Prefill logits, 32 bf16 layers with random weights: rounding differences
# grow through depth, so both bf16 models are held against the same weights
# run in fp32. The plain-attention bf16 model's distance from it is the bf16
# noise floor; the kernel's model may exceed that floor by at most 25%.
LOGITS_NOISE_MULT = 1.25
# The same rule for the first training step's gradients, per parameter
# tensor: ||g - g_fp32|| / ||g_fp32|| of the kernel model may exceed the
# plain-attention bf16 model's by at most 25%. Readings on llama2_1b (see
# PERF.md): both ~4.1e-2 median, 4.8e-2 max; kernel/plain per tensor
# 1.000 median, 1.025 max.
GRAD_NOISE_MULT = 1.25

# W8A16 serving, 32 layers of random weights: rounding noise grows through
# depth, so the W8 model is held against an fp32 model of its own
# dequantized weights, as the bf16 model against the fp32 model of its
# weights; its distance may exceed the bf16 one by at most 50%. Readings:
# ratio 1.160 at llama2_7b on an H100; 1.21 on the CPU at width 2048, 32
# layers. A wrong scale or layout moves logits by O(1), far beyond it.
W8_NOISE_MULT = 1.5
# The reference's bound on a stochastic int8 tree (tests/test_speculative.py):
# max|q*s - w| <= max|w| / 60 per matrix.
W8_WEIGHT_BOUND = 1 / 60
W8_SEED = 7

# Phase 3e, continuous batching at llama2_7b width: 24 requests from a
# numpy seed, prompts of 64-1000 tokens (buckets 128-1024) and 16-64 new
# tokens each, two submitted per engine step, on 8 slots of 2048 positions;
# engine (d) registers a 384-token prefix that 8 of the requests carry.
ENGINE_SEED, ENGINE_REQUESTS, ENGINE_SLOTS, ENGINE_MAX_LEN = 3, 24, 8, 2048
ENGINE_PREFIX, ENGINE_CARRIERS, ENGINE_PAGES = 384, 8, 160
# Each greedy token the engine emits must be within tau of the maximum of a
# teacher-forced, no-cache forward of the same bf16 model on the plain
# attention, at the same position, and at least EXACT_MIN of them must be
# its argmax. Random weights give near-tied logits, so the engine's bf16
# path (kernel prefill, M = 8 decode GEMMs) may pick a close second; a
# fault must not. Both limits sit between two readings on an H100 (see
# PERF.md), in units of phase 3's max|kernel - plain| prefill logits
# (0.3736): the sound engines' worst gap 0.199-0.246 (0.53-0.66 of it) and
# 86.7-87.1% exact; a control run with a planted fault (each decode step's
# K/V written one position late) 0.4235 (1.13 of it) as the smallest of
# its requests' worst gaps, and 54.2% exact. The control runs every time
# and must break both limits in every request.
TAU_MULT = 0.9
EXACT_MIN = 0.7
# Phase 3f, disaggregated prefill on phase 3e's traffic: the requests that
# the monolithic engine's second run moves into the decode engine
# mid-decode, the ancestor of the prefix in the base-aliased import, and a
# handoff's bytes a position at llama2_7b bf16: 32 layers x (K, V) x 8 kv
# heads x 128 x 2 B.
DISAGG_MIGRATED, DISAGG_ANCESTOR, HANDOFF_BYTES_PER_POSITION = 4, 256, 131072
# Phase 3g, speculative decoding on phase 3e's weights and traffic: proposals
# a round, the depth of the truncated draft, the requests of 3e it serves
# (the first 12 of 24: 4 carry the prefix, 460 of 924 new tokens; cut from
# 24 to keep the script in its time limit; the first 8 leave the control's
# exact share above EXACT_MIN, so 3g keeps 12), the requests the W8A16
# target serves, and the batch-1 request of speculative_generate (prompt,
# new; 16 new tokens, cut from 64 to make room for phase 15: its four
# speculative_generate calls and two plain generate calls took ~22 s).
SPEC_K, SPEC_DRAFT_LAYERS, SPEC_REQUESTS, SPEC_W8_REQUESTS = 4, 4, 12, 4
SPEC_B1_PROMPT, SPEC_B1_NEW = 512, 16
# The plain twins' times (phases 5, 5b, 6 (f), 10 (d), 11 (e), 19 (f)): a
# CUDA graph of PLAIN_ITERS calls, median of PLAIN_REPS (the kernels' 20 and
# 7 until phase 19; phase 5b's three plain twins alone took ~7.8 s so)
PLAIN_ITERS, PLAIN_REPS = 5, 3
# Phases 3, 3b and 6 (b): the 64-token generate is timed as the median of
# GEN64_REPS calls after a warm-up (5 before phase 19; a llama2_7b call
# takes ~2.7-3.0 s)
GEN64_REPS = 3
# Phase 3h, the int8 KV cache on phase 3e's weights and traffic: the
# requests of 3e it serves, the one it hands off (prompt 981: bucket 1024,
# not a prefix carrier) and that handoff's bytes, 1024 positions x 32
# layers x 8 kv heads x (K, V) x (128 int8 + one fp32 scale).
KV8_REQUESTS, KV8_HANDOFF_REQUEST = 8, 4
KV8_HANDOFF_BYTES = 1024 * 32 * 8 * 2 * (128 + 4)
# One decode step off the int8 cache, 32 bf16 layers of random weights:
# held, as phase 3's and 3b's logits are, against an fp32 model of the same
# weights with an fp32 cache; its distance may be at most 3x the bf16
# cache's. The reference's own oracle (tests/test_decode.py, 2 layers),
# max|int8 - bf16| / max|bf16| < 0.05, is below this depth's bf16 noise:
# the first reading on an H100 (see PERF.md) was 0.0907, where bf16 alone
# moves the prefill logits by 0.068 of their maximum from the fp32
# model's. int8 rounds each K, V element to within absmax/254, a few times
# bf16's relative rounding, so the two distances add to at most ~2.3x
# bf16's; a misplaced or misscaled K/V moves logits by O(max|logit|),
# ~14x it.
KV8_NOISE_MULT = 3.0
# Phase 7, the serving plane on phase 3e's weights and traffic: (a) the
# gateway's queue bound, its tenants' weights, the engine step that crashes
# and the deadline (s) of the request that expires mid-decode; (b) the
# fleet's prefix-affinity bucket; (d) the model pool's admissions a lane
# turn.
PLANE_QUEUE_BOUND = 16
PLANE_TENANTS = {"tenant-0": 1.0, "tenant-1": 2.0, "tenant-2": 4.0}
PLANE_CRASH_STEP, PLANE_DEADLINE_S = 5, 0.6
PLANE_PREFIX_BUCKET, PLANE_SWAP_BATCH = 16, 4
# the first requests of 3e's that (c) and (d) serve (module docstring)
PLANE_CUT = {"fleet": 16, "disagg_fleet": 8, "modelpool": 12}
# Phase 9, mesh-sharded serving at world 1: the requests of phase 3e it
# serves, the one it moves mid-decode in (c) and the steps before the move;
# each request's new tokens are capped at MESH_NEW (cut from 3e's 16-64 to
# make room for phase 17: every drive is ~16 steps, not ~61)
MESH_REQUESTS, MESH_MOVED, MESH_MOVE_STEPS, MESH_NEW = 8, 2, 6, 16
# Phase 3d: the serving plane's CLI forms, each at its defaults
PLANE_CLI_FLAGS = (("--gateway",), ("--replicas", "2", "--rollout-demo"))

# Phase 6, the GPT-2 family at gpt2_small width. The converters are driven
# with a namespace carrying GPT2Config's documented defaults (the card has
# no transformers).
GPT2_HF_CONFIG = dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
                      n_positions=1024, n_inner=None,
                      layer_norm_epsilon=1e-5,
                      activation_function="gelu_new")
# (c): 24 requests from numpy seed 5, prompts 64-896 tokens, 16-64 new
# tokens, two submitted per step, on 8 slots of the table's 1024
# positions; a 128-token prefix carried by 8 of the requests that fit it.
GPT2_SEED, GPT2_REQUESTS, GPT2_SLOTS, GPT2_PAGES = 5, 24, 8, 80
GPT2_PREFIX, GPT2_CARRIERS = 128, 8
# (c)'s teacher-forced gate, in units of (b)'s max|kernel - plain| prefill
# logits, calibrated as 3e's: between the sound engine's worst gap and the
# planted fault's least (readings in PERF.md).
GPT2_TAU_MULT = 0.9
GPT2_EXACT_MIN = 0.7
# (d): gpt2_small training, batch 8 x 1024, 8 steps on one batch; (e) the
# CLI at its defaults (8 x 512), 2 steps.
GPT2_TRAIN_BATCH, GPT2_TRAIN_SEQ, GPT2_TRAIN_STEPS = 8, 1024, 8

# Phase 15, the serving control plane over gpt2_small replicas:
# tests/test_autoscale.py's acceptance loop (_drive_burst) at full width.
# Replicas are engines of FLEET_SLOTS slots x the position table's 1024; the
# fake clock advances FLEET_DT a fleet step and the autoscaler ticks every
# second step under the loop's policy; one replica is one 8-GPU host
# (FLEET_TOPOLOGY), and a retired one drains FLEET_DRAIN_S virtual seconds
# before the reconciler reaps its pods. The burst: 3-5 requests a step over
# FLEET_BURST's steps from numpy seed FLEET_SEED, prompts of phase 6 (c)'s
# 64-896 tokens with 16-64 new; the prompt tokens come from a second stream
# (FLEET_TOKEN_STREAM), so that the burst's counts and lengths do not depend
# on the vocabulary. The loop's tail (60 idle steps) is kept: the longer
# requests drain before it starts counting. (b) runs at FLEET_CRASH_SEED
# under autoscale_under_crash, as the reference's crash case does.
FLEET_SEED, FLEET_CRASH_SEED, FLEET_TOKEN_STREAM = 0, 3, 1
FLEET_SLOTS, FLEET_MAX_LEN, FLEET_DT, FLEET_TAIL = 8, 1024, 0.05, 60
FLEET_BURST = (4, 14)
FLEET_ACCELERATOR, FLEET_TOPOLOGY, FLEET_DRAIN_S = (
    "nvidia-h100-80gb", "1x8", 1.0)
FLEET_POLICY = dict(min_replicas=1, max_replicas=4, target_ttft_s=0.3,
                    hysteresis=0.1, max_step=2, scale_up_cooldown_s=0.5,
                    scale_down_cooldown_s=1.5, flap_guard_s=1.0)
# the spec.slo block's TTFT objective: burn windows in virtual seconds
FLEET_SLO_WINDOWS = dict(window_s=60.0, fast_short_s=1.0, fast_long_s=2.0,
                         slow_short_s=5.0, slow_long_s=10.0)

# Phase 16, the capacity market over gpt2_small, built by the operator's
# entry. Every bid's unit is one 8-GPU host: a serving replica (1x8,
# spec.broker's unit_chips 1), a training worker (the elastic autoscaler's
# bid, unit 1) and a batch-lane unit (one engine of BROKER_LANE_SLOTS
# slots). So the market's capacity counts hosts: BROKER_CAPACITY = 1 serving
# replica + BROKER_TRAIN_HOSTS training hosts + 1 batch unit = 6, and before
# the burst the three consumers hold all of it (the lane's max_units 1 is
# what the fill gives it). The burst's first scale-up (phase 15's 1 -> 4)
# asks 3 more hosts and finds none free: the pressure episode's ladder
# harvests the batch lane's 1 and shrinks training by 2 to its floor
# BROKER_TRAIN_MIN, and the requester's retry is granted the 3. Rung 1
# (degrade) is off in spec.broker: its only variant for a model without a
# draft is int8 weights, which GPT-2's biased layers refuse
# (models/convert.py), so there is nothing cheaper to flip to. After the
# burst the serving scale-downs free hosts and the fill phase grants the
# lane again. The serving replicas run bf16; the lane's engine runs the
# same tree in fp32, since each item's tokens are held to a solo greedy
# generate of its prompt token for token, and in bf16 a batch of 8 and a
# batch of 1 round the logits apart enough to move an argmax now and then
# (phase 6 (c): ~2% of greedy tokens off the teacher-forced maximum). BROKER_LANE_ITEMS items, prompts of 64-512 tokens with 16-32
# new, from numpy stream (seed, BROKER_LANE_STREAM). (b) runs the
# reference's broker_grant_under_crash case on two replicas with
# BROKER_CRASH_REQUESTS requests.
BROKER_CAPACITY, BROKER_TRAIN_HOSTS, BROKER_TRAIN_MIN = 6, 4, 2
BROKER_LANE_ITEMS, BROKER_LANE_SLOTS, BROKER_LANE_STREAM = 12, 8, 16
BROKER_CRASH_REQUESTS, BROKER_MAX_STEPS, BROKER_TRAIN_LINES = 4, 2000, 5

# Phase 17, the load driver: the reference chip window's serve_ttft and
# serve_trace stages, flag for flag (the trace's --trace-out is added)
LOAD_TTFT_ARGV = ["--bench", "--n-slots", "8", "--n-requests", "48",
                  "--rate", "1.5"]
LOAD_TRACE_ARGV = ["--bench", "--disagg", "--n-slots", "4",
                   "--prefill-replicas", "1", "--decode-replicas", "2",
                   "--n-requests", "48", "--rate", "1.5", "--burst-rate",
                   "6.0", "--prefix-bucket", "128", "--shared-prefixes",
                   "2", "--shared-fraction", "0.8", "--prompt-min", "8",
                   "--prompt-max", "64"]
LOAD_SPANS = {"request", "queue", "prefill", "handoff", "decode"}

# Phase 18, the digital twin priced by the card: phase 15's replica engine
# (gpt2_small bf16, FLEET_SLOTS slots x FLEET_MAX_LEN) measured three ways
# and fitted by sim/calibrate. TWIN_STARTS replica starts (the weights from
# the host to the card, the engine's set-up and its first step, one
# TWIN_DECODE_PROMPT-token request: what the cost model's compile_s prices;
# the port compiles nothing at start); FLEET_SLOTS requests of
# TWIN_DECODE_PROMPT tokens and TWIN_DECODE_NEW new, every engine step at
# full occupancy timed (at least TWIN_MIN_STEPS of them); single-request
# admissions (max_new_tokens 1: the request retires at admission, so the
# step is its prefill) at TWIN_PREFILL_LENS, TWIN_PREFILL_REPS each after
# one unrecorded pass. Token ids from numpy seed TWIN_SEED. The fitted
# costs price TWIN_SCENARIO's replicas.
TWIN_STARTS, TWIN_DECODE_PROMPT, TWIN_DECODE_NEW = 3, 96, 48
TWIN_MIN_STEPS, TWIN_PREFILL_REPS, TWIN_SEED = 32, 2, 18
TWIN_PREFILL_LENS = (16, 64, 128, 256, 384, 512, 768, 1000)
TWIN_SCENARIO = "smoke"
TWIN_FITTED = ["step_s", "prefill_cost", "compile_s"]

# Phase 10, the vision models and BERT. (a) ResNet-50 at BASELINE.json's
# batch (256, then smaller ones if it does not fit), 10 adam steps on one
# batch from numpy seed 11 (weights from torch seed 11); its fp32 gate
# against the CPU: the logits of 8 images within this share of their
# largest (the two differ in summation order only, TF32 off; a wrong
# padding or BatchNorm moves them by O(1)); BASELINE.json's v5e images/s,
# printed beside the card's as a reading. (c) BERT-base at 32 x 128, 6
# steps, attn xla; (d) at 8 x 512, attn flash, each row's real length from
# numpy seed 6 in 64-512.
RESNET_SEED, RESNET_BATCHES, VISION_STEPS = 11, (256, 192, 128, 64), 10
RESNET_GATE_TOL = 1e-3
V5E_IMAGES_S = 2513.5
BERT_SEED, BERT_LEN_SEED, BERT_STEPS = 12, 6, 6
# (c)'s train_bert CLI steps (its default 50, ~7 s, until phase 19)
BERT_CLI_STEPS = 10
BERT_XLA_SHAPE, BERT_FLASH_SHAPE = (32, 128), (8, 512)

# Phase 11, sequence and pipeline parallelism on one card. (a) the ring at
# llama2_1b's attention width (B, H, L, D) in n chunks, and (b) Ulysses over
# n head groups, from this seed; (c) steps a run on the seq-1 mesh; (d)
# GPipe on (rows, seq) in microbatches, x and the loss's weights from this
# seed.
RING_SHAPE, RING_SEED = (1, 16, 8192, 128, 4), 13
# Phase 12, MoE at llama2_1b width with Mixtral-8x7B's routing: experts and
# top k; (a) the requests of phase 3e the engine serves and its weights'
# seed; (b) the training depth and the aux loss's weight; (d) the requests
# the mesh engines serve.
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_REQUESTS, MOE_SEED, MOE_TRAIN_LAYERS, MOE_AUX = 12, 12, 4, 0.01
MOE_MESH_REQUESTS = 4
# (a)'s teacher-forced gate, in units of the phase's max|kernel - plain|
# last-position prefill logits (0.7907 at the first reading): the sound
# engine's worst gap 0.3289 (0.42 of it), 94.35% exact; the control, whose
# engine drops each token's second expert, 33.48% exact, its requests'
# worst gaps median 0.8875 (1.12 of it), 9 of 12 above 0.9 of it (my chip
# run, PR 19, H100 80GB HBM3, 700 W; see PERF.md). The control cannot
# break tau in every request: where routing at random init sends most
# prompt tokens to two experts past their capacity, dropping the second
# expert leaves some short requests' greedy tokens unchanged. So it must
# break both limits as a whole: its exact share below MOE_EXACT_MIN and
# its worst gap above tau in at least MOE_CONTROL_SHARE of its requests.
MOE_TAU_MULT, MOE_EXACT_MIN, MOE_CONTROL_SHARE = 0.9, 0.7, 0.5
SEQ_STEPS = 2
PIPE_SHAPE, PIPE_SEED = (2, 2048, 2), 14
# Phase 5b, head dim 256: the kernels timed at google/gemma-7b's attention
# width (B, H, L, D, causal; its config's 16 heads x head_dim 256), and a
# model at that head dim made here (llama2_7b's widths at d_model 4096 over
# 16 heads, D_256_LAYERS layers, seeded random weights): generate on a
# (batch, prompt) prompt for D_256_NEW tokens, and the gradient gate on
# (batch, seq) tokens.
D_256_SHAPE, D_256_SEED, D_256_LAYERS = (4, 16, 2048, 256, True), 15, 2
D_256_PROMPT, D_256_NEW, D_256_BATCH = (2, 512), 16, (2, 1024)

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
# Phase 4c: the loop's steps (12 distinct batches from this numpy seed)
LOOP_STEPS, LOOP_SEED = 12, 4
# The int8 GEMM at the llama2_1b training shapes, M = batch x seq rows:
# (N, K, out) for wq/wo, wk/wv, the fused gate+up, w_down and the fp32-out
# head, then ragged shapes.
INT8_CASES = [(TRAIN_BATCH * TRAIN_SEQ, 2048, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 1024, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 11264, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 2048, 5632, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 32000, 2048, torch.float32),
              (333, 1000, 200, torch.bfloat16),
              (333, 1000, 5632, torch.float32)]
# quantize: the llama2_7b matrices as the W8 tree quantizes them (rows =
# output channels; the head transposed), and ragged shapes
QUANT_CASES = [(4096, 4096, torch.bfloat16), (1024, 4096, torch.bfloat16),
               (11008, 4096, torch.bfloat16), (4096, 11008, torch.bfloat16),
               (32000, 4096, torch.bfloat16), (333, 1001, torch.bfloat16),
               (333, 1001, torch.float32)]
# quantize at its edges: (r, c, dtype, kind), kind shaping the values: a
# row of zeros, a row with one non-zero, subnormal values (with and without
# a large value in the row), a huge and a tiny value in one row, and a
# contiguous slice whose base is not 16-byte aligned; C 1, 3 and 17 and a
# C * size that is not a multiple of 16 take the element-wise kernel; C
# 32000 fp32 (125 KB rows) streams through the ring in chunks
QUANT_EDGE_CASES = [(64, 4096, torch.bfloat16, "zeros"),
                    (64, 4096, torch.bfloat16, "one"),
                    (64, 4096, torch.float32, "subnormal"),
                    (64, 4096, torch.bfloat16, "subnormal"),
                    (50, 1000, torch.float32, "huge"),
                    (100, 4096, torch.bfloat16, "misaligned"),
                    (5000, 1, torch.bfloat16, None),
                    (333, 3, torch.float32, None),
                    (333, 17, torch.bfloat16, None),
                    (77, 4100, torch.float16, None),
                    (2048, 32000, torch.float32, None)]
# dequantize: the llama2_1b fp32 masters' rows, and ragged shapes; C 1, 3
# and 17, and bf16 and fp16 out at the head's [2048, 32000]
DEQUANT_CASES = [(5632, 2048, torch.float32), (32000, 2048, torch.float32),
                 (2048, 32000, torch.float32), (333, 1001, torch.bfloat16),
                 (333, 1001, torch.float32), (500, 1, torch.float32),
                 (333, 3, torch.bfloat16), (333, 17, torch.float16),
                 (2048, 32000, torch.bfloat16), (2048, 32000, torch.float16)]
# Head dims the flash kernels are not built for (zero-padded to 64, 128 or
# 256 in the wrappers), forward and backward, causal, GQA rep 2:
# (d, l) with 4 q-heads on 2 kv heads, batch 1
HEAD_DIM_CASES = [(d, l) for d in (16, 32, 80, 96, 192) for l in (129, 2047)]
# The int8_impl="xla" route (torch._int_mm, zero-padded to the shapes it
# takes on the card) at decode's M and ragged K, N: (m, n, k)
INT_MM_CASES = [(m, 129, 40) for m in (1, 16, 17)]
# The bf16 flash kernels at their tile edges (128-row query tiles and K/V
# tiles of 128 keys in the forward, 64 at D 256; 128-row query tiles and
# 64-key tiles in dq; 128-key tiles, 64 at D 256, and 64-row query tiles in
# dk/dv), with 4 q-heads on 4, 2 and 1 kv heads: (h, hkv, l, d, causal,
# valid_len, segments), batch 1; "tile" segments are cut at rows 120 and
# 136, across the 128-row boundary.
EDGE_CASES = ([(4, hkv, l, d, True, 0, None) for d in (64, 128, 256)
               for l in (63, 64, 65, 127, 128, 129, 255, 2047)
               for hkv in (4, 2, 1)]
              + [(4, 1, 255, d, True, 129, None) for d in (64, 128, 256)]
              + [(4, 2, 255, d, True, 0, "tile") for d in (64, 128, 256)]
              + [(4, 4, 300, d, False, 0, "tile") for d in (64, 128, 256)])
# The int8 GEMM at its tile edges (128 x 256 output tiles, 128-byte K
# tiles), fp32 and bf16 out: (m, n, k, out); K 40 takes the byte-wise path.
INT8_EDGE_CASES = ([(m, n, k, out) for m in (1, 127, 129, 8192)
                    for n in (129, 257) for k in (16, 48, 2064)
                    for out in (torch.float32, torch.bfloat16)]
                   + [(129, 257, 40, torch.bfloat16)])
# the kernels whose SASS must hold wgmma (HGMMA, IGMMA) instructions:
# (library, kernel function name)
WGMMA_KERNELS = (("flash_fwd", "flash_fwd_sm90_kernel"),
                 ("flash_bwd", "dq_sm90_kernel"),
                 ("flash_bwd", "dkv_sm90_kernel"),
                 ("int8_matmul", "int8_matmul_sm90_kernel"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sass_stats(lib) -> dict:
    """Per kernel function in the SASS of a built library, read with
    ``cuobjdump --dump-sass`` from the toolkit of the nvcc that built it:
    (wgmma instructions, ``HGMMA`` or ``IGMMA``; the highest register
    ``R<n>`` it names). A consumer branch that names registers past the
    launch's count runs on what ``setmaxnreg`` gave it."""
    from tpu_on_k8s_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    stats, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            stats[fn] = [0, -1]
        elif fn is not None:
            stats[fn][0] += "HGMMA" in line or "IGMMA" in line
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            stats[fn][1] = max([stats[fn][1], *regs])
    return {fn: tuple(v) for fn, v in stats.items()}


def time_ms(fn, iters: int = 20, reps: int = 7, stream=None) -> float:
    """Median device time of one ``fn()`` call: ``iters`` calls captured in
    a CUDA graph (no host launch cost inside), replayed ``reps`` times
    between CUDA events, after warm-up; warmed up and captured on
    ``stream`` when given (``sdpa_backward``'s)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def plain_time_ms(fn) -> float:
    """``time_ms`` for a kernel's plain twin: a CUDA graph of PLAIN_ITERS
    calls, median of PLAIN_REPS (a plain twin takes 10-100x its kernel)."""
    return time_ms(fn, iters=PLAIN_ITERS, reps=PLAIN_REPS)


def event_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median device time of one ``fn()`` call between CUDA events, without
    a graph (for autograd calls), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def sdpa_backward(q, k, v, do, **sdpa_kwargs):
    """(``fn``, ``stream``): ``fn()`` runs SDPA's backward through autograd
    for ``scaled_dot_product_attention(q, k, v, **sdpa_kwargs)``, whose
    forward ran once on ``stream``. Autograd runs each backward operator on
    its forward's stream, so ``time_ms(fn, stream=stream)`` captures the
    library's backward kernels in a CUDA graph and times them as it times
    the kernels (``make_graphed_callables`` captures a backward the same
    way)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, **sdpa_kwargs)
    torch.cuda.current_stream().wait_stream(stream)
    return (lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                        retain_graph=True)), stream


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn()`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median(xs) -> float:
    """The median of ``xs``, nan when there are none."""
    xs = list(xs)
    return statistics.median(xs) if xs else math.nan


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time for the work on this card: the larger of its
    operations at their tensor-core peak (bf16 unless given) and its bytes
    at the memory rate."""
    flop_s, byte_s = flops / peak, nbytes / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s > byte_s
                                       else "bytes")


def int8_bound_ms(m, n, k, out_dtype) -> tuple[float, str]:
    """The int8 GEMM: 2·M·N·K int8 operations; xq, wq and the fp32 scales
    read once, the output written once."""
    out_bytes = torch.finfo(out_dtype).bits // 8
    return bound_ms(2 * m * n * k, m * k + n * k + 4 * (m + n)
                    + out_bytes * m * n, PEAK_INT8_OPS)


def quant_bound_ms(r, c, in_dtype) -> tuple[float, str]:
    """Quantize: x read once, int8 values and fp32 scales written once."""
    return bound_ms(0, (torch.finfo(in_dtype).bits // 8) * r * c + r * c
                    + 4 * r)


def dequant_bound_ms(r, c, out_dtype) -> tuple[float, str]:
    """Dequantize: values and scales read once, the output written once."""
    return bound_ms(0, r * c + 4 * r + (torch.finfo(out_dtype).bits // 8)
                    * r * c)


def causal_pairs(l: int, causal: bool) -> int:
    return l * (l + 1) // 2 if causal else l * l


def flash_bound_ms(b, h, hkv, l, d, causal,
                   pairs=None) -> tuple[float, str]:
    """The bf16 flash forward: QK^T and PV over the kept pairs (``pairs``:
    the batch's kept (query, key) pairs a head, where the data decides
    them); q, k, v read once, o and the fp32 lse written once."""
    pairs = b * causal_pairs(l, causal) if pairs is None else pairs
    return bound_ms(4 * h * d * pairs,
                    2 * (2 * b * h * l * d + 2 * b * hkv * l * d)
                    + 4 * b * h * l)


def dq_bound_ms(b, h, hkv, l, d, causal,
                pairs=None) -> tuple[float, str]:
    """The bf16 dq kernel: QK^T, dO V^T and dS K over the kept pairs; q, dO,
    k, v, lse and delta read once, dq written once."""
    pairs = b * causal_pairs(l, causal) if pairs is None else pairs
    return bound_ms(6 * h * d * pairs,
                    2 * (3 * b * h * l * d + 2 * b * hkv * l * d)
                    + 2 * 4 * b * h * l)


def dkv_bound_ms(b, h, hkv, l, d, causal,
                 pairs=None) -> tuple[float, str]:
    """The bf16 dk/dv kernel: QK^T, dO V^T, P^T dO and dS^T Q over the kept
    pairs; q, dO, k, v, lse and delta read once, dk and dv written once."""
    pairs = b * causal_pairs(l, causal) if pairs is None else pairs
    return bound_ms(8 * h * d * pairs,
                    2 * (2 * b * h * l * d + 4 * b * hkv * l * d)
                    + 2 * 4 * b * h * l)


def counts(fa) -> tuple[int, int, int]:
    return fa.launches, fa.dq_launches, fa.dkv_launches


#: each kernel's launch counter: (module key, attribute)
COUNTERS = {"flash_fwd": ("fa", "launches"),
            "flash_bwd_dq": ("fa", "dq_launches"),
            "flash_bwd_dkv": ("fa", "dkv_launches"),
            "int8_matmul": ("i8", "launches"),
            "quantize_int8": ("qz", "quant_launches"),
            "dequantize_int8": ("qz", "dequant_launches")}


def reset_counts(mods) -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    for key, attr in COUNTERS.values():
        setattr(mods[key], attr, 0)


def read_counts(mods) -> dict:
    """Every kernel's launch count, just after a path ran."""
    return {name: getattr(mods[key], attr)
            for name, (key, attr) in COUNTERS.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def quant_edge_input(randn, r, c, dtype, kind):
    """The input of a ``QUANT_EDGE_CASES`` case."""
    x = randn(r, c, dtype=dtype) * 0.02
    if kind == "zeros":
        x[::2] = 0
    elif kind == "one":
        x.zero_()
        x[:, 5] = torch.arange(1, r + 1, device=x.device, dtype=dtype)
    elif kind == "subnormal":
        x = (x * (torch.finfo(dtype).smallest_normal / 0.08)).to(dtype)
        x[1::3, 7] = 1.0
    elif kind == "huge":
        x[:, 0] = 3e35
        x[:, 1] = 1e-35
    elif kind == "misaligned":
        flat = randn(r * c + 8, dtype=dtype) * 0.02
        x = flat[1:1 + r * c].view(r, c)
        if x.data_ptr() % 16 == 0 or not x.is_contiguous():
            fail("the misaligned quantize case is aligned")
    return x


def check_division(i8, decode, misses: list) -> None:
    """Phase 2: the row scales of ``_quant_rows`` and of the serving
    quantizer on the card against the same functions on the CPU, which
    divide by 127 as the reference does. A Python-float divisor takes
    CUDA's reciprocal route (x * fp32(1/127)); the count of rows where that
    form differs is printed beside."""
    rows = torch.randn(4096, 64, generator=torch.Generator().manual_seed(3))
    q_cpu, s_cpu = i8._quant_rows(rows)
    q_gpu, s_gpu = i8._quant_rows(rows.cuda())
    recip = torch.clamp(rows.cuda().abs().amax(-1, keepdim=True),
                        min=1e-30) / 127.0
    wq_cpu, ws_cpu = decode._absmax_rows(rows)
    wq_gpu, ws_gpu = decode._absmax_rows(rows.cuda())
    same = (torch.equal(s_gpu.cpu(), s_cpu)
            and torch.equal(q_gpu.cpu(), q_cpu))
    same_w = (torch.equal(ws_gpu.cpu(), ws_cpu)
              and torch.equal(wq_gpu.cpu(), wq_cpu))
    print(f"[kernel] division by 127 on the card, 4096 rows of 64: "
          f"_quant_rows scales and values equal the CPU's {same}; serving "
          f"quantizer {same_w}; a Python-float divisor (x / 127.0 on the "
          f"card) differs from the CPU's division in "
          f"{(recip.cpu() != s_cpu).sum().item()} rows "
          f"{'ok' if same and same_w else 'MISS'}")
    if not (same and same_w):
        misses.append("division by 127 on the card")


def check_int8_kernels(i8, qz, randn, misses: list) -> dict:
    """Phase 2 for the int8 GEMM, quantize and dequantize kernels: each
    against its plain version bit for bit (the GEMM also against the
    ``torch._int_mm`` route, at the training shapes and at decode's M).
    Returns max |kernel - plain| per kernel."""
    errs = {"int8_matmul": 0.0, "quantize_int8": 0.0, "dequantize_int8": 0.0}
    one = torch.ones(1, 40, dtype=torch.int8, device="cuda")
    try:
        torch._int_mm(one, torch.ones(40, 129, dtype=torch.int8,
                                      device="cuda"))
        said = "takes it"
    except RuntimeError as e:
        said = f"refuses it: {str(e).splitlines()[0]}"
    print(f"[kernel] torch {torch.__version__}: torch._int_mm at M=1 K=40 "
          f"N=129 {said}")
    for m, n, k in INT_MM_CASES:
        xq, sx = i8._quant_rows(randn(m, k))
        wq, sw = i8._quant_rows(randn(n, k) * 0.02)
        for out in (torch.bfloat16, torch.float32):
            got = i8._int_mm(xq, sx, wq, sw, out)
            ok = torch.equal(got, i8.int8_matmul_plain(xq, sx, wq, sw, out))
            label = (f"the _int_mm route M={m} N={n} K={k} out "
                     f"{dtype_name(out)}")
            print(f"[kernel] {label} (zero-padded): bit-identical to plain "
                  f"{ok} {'ok' if ok else 'MISS'}")
            if not ok:
                misses.append(label)
    for m, n, k, out in INT8_CASES:
        xq, sx = i8._quant_rows(randn(m, k))
        wq, sw = i8._quant_rows(randn(n, k) * 0.02)
        got = i8.int8_matmul_kernel(xq, sx, wq, sw, out)
        plain = i8.int8_matmul_plain(xq, sx, wq, sw, out)
        lib = i8._int_mm(xq, sx, wq, sw, out)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        same, same_lib = torch.equal(got, plain), torch.equal(got, lib)
        ok = same and same_lib and bool(torch.isfinite(got).all())
        errs["int8_matmul"] = max(errs["int8_matmul"], err)
        label = f"int8_matmul M={m} N={n} K={k} out {dtype_name(out)}"
        print(f"[kernel] {label}: max|kernel-plain| {err:.3e}; bit-identical "
              f"to plain {same}, to the torch._int_mm route {same_lib} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
        del xq, wq, got, plain, lib
    edge_same = 0
    for m, n, k, out in INT8_EDGE_CASES:
        xq, sx = i8._quant_rows(randn(m, k))
        wq, sw = i8._quant_rows(randn(n, k) * 0.02)
        got = i8.int8_matmul_kernel(xq, sx, wq, sw, out)
        plain = i8.int8_matmul_plain(xq, sx, wq, sw, out)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        errs["int8_matmul"] = max(errs["int8_matmul"], err)
        if torch.equal(got, plain):
            edge_same += 1
        else:
            misses.append(f"int8_matmul M={m} N={n} K={k} out "
                          f"{dtype_name(out)}: max|kernel-plain| {err:.3e}")
    print(f"[kernel] int8_matmul at its tile edges (M 1/127/129/8192, N "
          f"129/257, K 16/48/2064, fp32 and bf16 out; K 40 byte-wise): "
          f"bit-identical to plain in {edge_same} of {len(INT8_EDGE_CASES)} "
          f"{'ok' if edge_same == len(INT8_EDGE_CASES) else 'MISS'}")
    for r, c, dtype, kind in ([(*case, None) for case in QUANT_CASES]
                              + QUANT_EDGE_CASES):
        x = quant_edge_input(randn, r, c, dtype, kind)
        values, scales = qz.quantize_int8(x, seed=W8_SEED)
        pvalues, pscales = qz.quantize_int8_plain(x, seed=W8_SEED)
        torch.cuda.synchronize()
        err = (values.int() - pvalues.int()).abs().max().item()
        ok = torch.equal(values, pvalues) and torch.equal(scales, pscales)
        errs["quantize_int8"] = max(errs["quantize_int8"], float(err))
        label = (f"quantize_int8 R={r} C={c} {dtype_name(dtype)}"
                 + (f" {kind}" if kind else ""))
        print(f"[kernel] {label}: values and scales bit-identical to plain "
              f"{ok} (max |value diff| {err}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    for r, c, dtype in DEQUANT_CASES:
        values, scales = qz.quantize_int8(randn(r, c, dtype=torch.float32),
                                          seed=1)
        got = qz.dequantize_int8(values, scales, dtype)
        plain = qz.dequantize_int8_plain(values, scales, dtype)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        ok = torch.equal(got, plain)
        errs["dequantize_int8"] = max(errs["dequantize_int8"], err)
        label = f"dequantize_int8 R={r} C={c} -> {dtype_name(dtype)}"
        print(f"[kernel] {label}: max|kernel-plain| {err:.3e}, bit-identical "
              f"{ok} {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    return errs


def dequantized(wparams: dict) -> dict:
    """The bf16-layout state dict of a W8 tree's dequantized weights, q·s
    in fp32 (other tensors as they are)."""
    out = {}
    for name, t in wparams.items():
        if name == "lm_head_q":
            out["lm_head"] = t.float() * wparams["lm_head_scale"]
        elif name.endswith(".weight_q"):
            out[name[:-2]] = t.float() * wparams[name[:-2] + "_scale"][:, None]
        elif not (name.endswith(".weight_scale") or name == "lm_head_scale"):
            out[name] = t
    return out


def serve_w8(cfg, params, prompt4, prefill_logits, mods, convert, decode):
    """Phase 3b: the W8A16 tree of ``params`` through the quantize kernel,
    served; the checks; prefill and decode times. Returns the readings."""
    n_mats = 7 * cfg.n_layers + 1
    reset_counts(mods)
    t0 = time.perf_counter()
    wcfg, wparams = convert.quantize_serving_tree(cfg, params,
                                                  stochastic=True,
                                                  seed=W8_SEED)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    after_convert = read_counts(mods)
    w8_gb = sum(t.numel() * t.element_size() for n, t in wparams.items()
                if n.endswith("_q") or n.endswith("_scale")) / 1e9
    print(f"[serve-w8] quantize_serving_tree(stochastic=True, seed="
          f"{W8_SEED}): {after_convert['quantize_int8']} quantize launches for "
          f"{n_mats} matrices in {convert_s:.2f} s; int8 weights and scales "
          f"{w8_gb:.2f} GB")
    others = [v for k, v in after_convert.items() if k != "quantize_int8"]
    if any(others) or after_convert["quantize_int8"] != n_mats:
        fail(f"conversion launches {after_convert}; expected {n_mats} "
             f"quantize launches and nothing else")
    worst = 0.0
    for name, q in wparams.items():
        if not name.endswith("_q"):
            continue
        if name == "lm_head_q":
            w, back = params["lm_head"], q.float() * wparams["lm_head_scale"]
        else:
            w = params[name[:-2]]
            back = q.float() * wparams[name[:-2] + "_scale"][:, None]
        worst = max(worst, (back - w.float()).abs().max().item()
                    / (w.float().abs().max().item() * W8_WEIGHT_BOUND))
        del back
    print(f"[serve-w8] every matrix: max|q*s - w| / (max|w| / 60) at most "
          f"{worst:.4f} (limit 1)")
    if worst > 1:
        fail("a stochastic int8 matrix strays beyond the reference's bound")

    greedy = decode.generate(wcfg, wparams, prompt4, 64)
    torch.cuda.synchronize()
    path = read_counts(mods)
    print(f"[serve-w8] request 1 from the int8 tree: batch 4 x prompt 512 -> "
          f"64 tokens, greedy; launches {path}")
    if path["flash_fwd"] != cfg.n_layers or path["quantize_int8"] != n_mats:
        fail(f"W8 serving launches {path}: expected {cfg.n_layers} flash_fwd "
             f"for the prefill")
    if tuple(greedy.shape) != (4, 64) or greedy.dtype != torch.int32 or \
            int(greedy.min()) < 0 or int(greedy.max()) >= cfg.vocab_size:
        fail(f"W8 tokens {tuple(greedy.shape)} {greedy.dtype} out of range")
    if not torch.equal(decode.generate(wcfg, wparams, prompt4, 64), greedy):
        fail("a repeated W8 greedy run gave other tokens")
    print(f"[serve-w8] greedy row 0: {greedy[0, :16].tolist()} ...; tokens "
          f"in [0, vocab); repeated run identical")

    lw8 = prefill_logits(wcfg, wparams)
    lbf16 = prefill_logits(cfg, params)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    deq = dequantized(wparams)
    ldeq = prefill_logits(f32, deq)
    del deq
    full = {n: p.float() for n, p in params.items()}
    l32 = prefill_logits(f32, full)
    del full
    torch.cuda.synchronize()
    noise_w8 = (lw8 - ldeq).abs().max().item()
    noise_bf16 = (lbf16 - l32).abs().max().item()
    rel = ((lw8 - lbf16).abs().max() / lbf16.abs().max()).item()
    agree = (lw8.argmax(-1) == lbf16.argmax(-1)).float().mean().item()
    print(f"[serve-w8] prefill logits [4, 512, {cfg.vocab_size}]: max|W8 - "
          f"fp32 model of its dequantized weights| {noise_w8:.3e} (tol "
          f"{W8_NOISE_MULT:g} x bf16 noise {noise_bf16:.3e} = max|bf16 - fp32 "
          f"model|; ratio {noise_w8 / noise_bf16:.3f})")
    print(f"[serve-w8] reading, not a gate: max|W8 - bf16| / max|bf16| = "
          f"{rel:.4f} (the reference's 0.05 gate of its 2-layer width-64 "
          f"test; 32 layers of random weights amplify the int8 rounding); "
          f"argmax agreement W8/bf16 {agree:.4f}")
    if not bool(torch.isfinite(lw8).all()):
        fail("W8 prefill logits not finite")
    if noise_w8 > W8_NOISE_MULT * noise_bf16:
        fail("the W8 model strays further from the fp32 model of its weights "
             "than bf16 rounding explains")
    del lw8, lbf16, ldeq, l32
    prefill_ms = wall_ms(lambda: decode.generate(wcfg, wparams, prompt4, 1))
    gen64_ms = wall_ms(lambda: decode.generate(wcfg, wparams, prompt4, 64),
                       GEN64_REPS)
    return {"counts": path, "prefill_ms": prefill_ms, "gen64_ms": gen64_ms,
            "decode_ms": (gen64_ms - prefill_ms) / 63, "rel": rel,
            "ratio": noise_w8 / noise_bf16, "noise": noise_w8,
            "convert_s": convert_s, "gb": w8_gb, "tree": (wcfg, wparams)}


def pytree_roundtrip(tparams: dict, mods) -> dict:
    """Phase 3b's second path: ``quantize_pytree`` / ``dequantize_pytree``
    over fp32 master weights, with the reference's checks."""
    qz = mods["qz"]
    reset_counts(mods)
    packed = qz.quantize_pytree(tparams, seed=W8_SEED)
    back = qz.dequantize_pytree(packed)
    torch.cuda.synchronize()
    path = read_counts(mods)
    n_q8 = sum(kind == "q8" for kind, _ in packed.values())
    raw = small = 0
    excess = -1.0
    for name, (kind, payload) in packed.items():
        if kind != "q8":
            continue
        values, scales, shape, _ = payload
        x = tparams[name].reshape(-1, shape[-1])
        err = (back[name].reshape(x.shape) - x).abs()
        excess = max(excess, (err - scales - 1e-6).max().item())
        raw += x.numel() * x.element_size()
        small += values.numel() + scales.numel() * 4
    print(f"[pytree] quantize_pytree -> dequantize_pytree on the llama2_1b fp32 "
          f"masters: {n_q8} matrices, launches {path}; max(|back - x| - "
          f"scale) per row {excess:.3e} (must be <= 1e-6); packed/raw "
          f"{small / raw:.4f} (limit 1/3.8 = {1 / 3.8:.4f})")
    if path["quantize_int8"] != n_q8 or path["dequantize_int8"] != n_q8:
        fail(f"pytree launches {path}; expected {n_q8} of each")
    if excess > 0 or not small / raw < 1 / 3.8:
        fail("pytree round trip out of bounds")
    del packed, back
    return {"counts": path}


def serve_int8_routes(cfg, params, prompt4, mods, decode) -> dict:
    """Phase 3c: ``mlp_int8`` + ``head_int8`` serving at batch 4, 16 greedy
    tokens, on the ``int8_impl="xla"`` route (``torch._int_mm``, zero-padded
    at decode's M of 4) and on the "pallas" route (the int8 GEMM kernel):
    the two routes compute the same bits, so their tokens must be equal.
    Returns the pallas route's launches."""
    toks, launched = {}, {}
    for impl in ("xla", "pallas"):
        icfg = dataclasses.replace(cfg, mlp_int8=True, head_int8=True,
                                   int8_impl=impl)
        reset_counts(mods)
        toks[impl] = decode.generate(icfg, params, prompt4, 16)
        torch.cuda.synchronize()
        launched[impl] = read_counts(mods)
    # 16 forward calls (the prefill and 15 steps), each with the MLP's three
    # products in every layer and the head
    want = 16 * (3 * cfg.n_layers + 1)
    same = torch.equal(toks["xla"], toks["pallas"])
    print(f"[serve-int8] llama2_7b bf16 weights, mlp_int8 + head_int8, batch 4 "
          f"x prompt 512 -> 16 greedy tokens: int8_impl xla (torch._int_mm at "
          f"M=4, padded) and pallas give equal tokens {same}; int8_matmul "
          f"launches xla {launched['xla']['int8_matmul']}, pallas "
          f"{launched['pallas']['int8_matmul']} (expected 0 and {want}); "
          f"row 0 {toks['pallas'][0].tolist()}")
    if not same:
        fail("the xla and pallas int8 routes gave other tokens")
    if (launched["xla"]["int8_matmul"] != 0
            or launched["pallas"]["int8_matmul"] != want):
        fail(f"int8 serving launches {launched}")
    return launched["pallas"]


def run_clis(mods, dev, tmp: Path) -> dict:
    """Phase 3d: the three CLIs with their own defaults (``--config tiny``
    on ``cuda``: head dim 16, through the padded flash kernels), in
    process, then their checkpoint flags (``checkpoint_cli_roundtrip``).
    Returns their launches."""
    import contextlib
    import io

    from tpu_on_k8s_torch import generate as generate_cli
    from tpu_on_k8s_torch import serve as serve_cli
    from tpu_on_k8s_torch import train_llama

    reset_counts(mods)
    out, served_out = io.StringIO(), io.StringIO()
    plane_out = {flags: io.StringIO() for flags in PLANE_CLI_FLAGS}
    with contextlib.redirect_stdout(out):
        tokens = generate_cli.main([])
        loss = train_llama.main([])
    with contextlib.redirect_stdout(served_out):
        served = serve_cli.main([])
    plane_done = {}
    for flags, buf in plane_out.items():
        with contextlib.redirect_stdout(buf):
            plane_done[flags] = serve_cli.main(list(flags))
    checkpoint_cli_roundtrip(mods, dev, tmp)
    torch.cuda.synchronize()
    launched = read_counts(mods)
    lines = out.getvalue().splitlines()
    print(f"[cli] python -m tpu_on_k8s_torch.generate (defaults: tiny, cuda): "
          f"tokens {tuple(tokens.shape)}; python -m tpu_on_k8s_torch."
          f"train_llama (defaults: tiny, cuda, 50 steps): final loss "
          f"{loss:.5f}; {len(lines)} lines of output, the last: {lines[-1]}; "
          f"launches {launched}")
    print(f"[cli] python -m tpu_on_k8s_torch.serve (defaults: tiny, cuda, 16 "
          f"requests): {served_out.getvalue().splitlines()[-1]}")
    for flags, buf in plane_out.items():
        lines = buf.getvalue().splitlines()
        print(f"[cli] python -m tpu_on_k8s_torch.serve {' '.join(flags)} "
              f"(tiny, cuda): " + " | ".join(
                  ln for ln in lines if ln.startswith(
                      ("served", "fleet served", "rollout phases"))))
    if (tuple(tokens.shape) != (1, 32) or not math.isfinite(loss)
            or len(served) != 16
            or any(t.shape != (16,) for t in served.values())
            or any(len(done) != 16 or any(t.shape != (16,)
                                          for t in done.values())
                   for done in plane_done.values())):
        fail("a CLI with its own defaults did not finish")
    if not (launched["flash_fwd"] and launched["flash_bwd_dq"]
            and launched["flash_bwd_dkv"]):
        fail(f"the CLIs did not run the flash kernels: {launched}")
    return launched


class _CountProducts(TorchDispatchMode):
    """Counts the dense products (``aten.mm``) run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def engine_traffic(vocab: int):
    """Phase 3e's requests [(prompt, max_new_tokens)], the prefix and the
    indices of the requests that carry it, from ENGINE_SEED."""
    rng = np.random.default_rng(ENGINE_SEED)
    reqs = [(rng.integers(0, vocab, size=int(rng.integers(64, 1001)))
             .astype(np.int32), int(rng.integers(16, 65)))
            for _ in range(ENGINE_REQUESTS)]
    prefix = rng.integers(0, vocab, size=ENGINE_PREFIX).astype(np.int32)
    carriers = set(rng.choice(ENGINE_REQUESTS, ENGINE_CARRIERS,
                              replace=False).tolist())
    return reqs, prefix, carriers


def drive_engine(engine, reqs, prefix, carriers, mods, clock,
                 draft=None, also=()) -> dict:
    """Serve ``reqs`` on ``engine`` (two submitted per step until all are
    in; with ``prefix``, registered first and carried by ``carriers``) and
    check its flash launches: one a layer per prefill from an empty cache,
    as the engine counts them in ``stats["fresh_prefills"]`` (the batched
    admissions, the prefix, each chunked prompt's first chunk; never a
    later chunk or a suffix), and, for a speculative engine, one a draft
    layer per fresh draft prefill as its ``draft`` runner counts them
    (each admission's seed and the mirrored prefix; never a suffix seed
    after it), and that no other kernel launched (but those in ``also``,
    whose count is the caller's to check). Returns the tokens, the
    launches, the prefix id and the
    times: decode steps entered with every slot busy (host clock; each
    step ends in its copy of tokens to the host), admission prefills by
    (bucket, batch) on CUDA events (no synchronize inside the run), time to
    first token on the engine's ``clock``, and the wall time."""
    # the metrics objects record no prefill time: events around the
    # engine's own prefill call take them
    events = []
    prefill_call = engine._prefill

    def prefill(prompts, lps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = prefill_call(prompts, lps)
        end.record()
        events.append((prompts.shape[::-1], start, end))
        return out

    engine._prefill = prefill
    before = read_counts(mods)
    t_start = time.perf_counter()
    pid = engine.register_prefix(prefix) if prefix is not None else None
    submitted, first, out, step_ms = {}, {}, {}, []

    def on_token(rid, tok):
        first.setdefault(rid, clock())

    while len(out) < len(reqs):
        for _ in range(2):
            j = len(submitted)
            if j < len(reqs):
                submitted[j] = clock()
                rid = engine.submit(*reqs[j], on_token=on_token,
                                    prefix_id=pid if j in carriers else None)
                if rid != j:
                    fail(f"engine request id {rid} for request {j}")
        full = engine.free_slots == 0
        t0 = time.perf_counter()
        for rid in engine.step():     # ends in the step's copy to the host
            out[rid] = engine.result(rid)
        if full:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    after = read_counts(mods)
    launched = {name: after[name] - before[name] for name in after}
    fresh = engine.stats["fresh_prefills"]
    want = engine.cfg.n_layers * fresh
    if draft is not None:
        want += draft._prefill_model.cfg.n_layers * draft.fresh_prefills
    for j, (_, n) in enumerate(reqs):
        if j not in out or out[j].shape != (n,):
            fail(f"engine request {j}: {out.get(j)} for {n} new tokens")
    if (launched["flash_fwd"] != want
            or any(c for name, c in launched.items()
                   if name not in ("flash_fwd", *also))):
        fail(f"engine launches {launched} for {fresh} fresh prefills "
             f"(engine stats {engine.stats}), expected {want} flash_fwd")
    torch.cuda.synchronize()
    prefill_ms: dict = {}
    for shape, start, end in events:
        prefill_ms.setdefault(shape, []).append(start.elapsed_time(end))
    return {"tokens": out, "launched": launched, "fresh": fresh, "pid": pid,
            "step_ms": step_ms, "prefill_ms": prefill_ms,
            "ttft_ms": [(first[j] - submitted[j]) * 1e3 for j in out],
            "wall": wall, "emitted": sum(len(t) for t in out.values())}


def flash_checked(transformer, plain_flash, worst: dict):
    """Patch the model's ``flash_attention`` so that each call runs the
    kernel (counted, its output returned) and then the plain attention on
    the same q, k, v, keeping max|o - plain| per (L, B) in ``worst``."""
    kernel = transformer.flash_attention

    def checked(q, k, v, causal=True, segments=None):
        o = kernel(q, k, v, causal, segments)
        err = (o.float() - plain_flash(q, k, v, causal, segments).float()
               ).abs().max().item()
        key = (q.shape[1], q.shape[0])
        worst[key] = max(worst.get(key, 0.0), err)
        return o

    return mock.patch.object(transformer, "flash_attention", checked)


def teacher_forced_gaps(model, reqs, tokens, prefix, carriers, plain_flash,
                        transformer, decode, over_cache=False) -> list:
    """max logit - logit[emitted token] at every emitted position, from one
    no-cache forward per request of prompt + emitted tokens on the plain
    attention (the flash kernel patched out). With ``over_cache`` (a model
    of the int8 KV cache) the sequence goes in as the engine feeds its
    cache: the prompt (a carrier's: the prefix) from an empty cache, then
    the rest in one call over the cache, so that every later query reads
    the quantized K and V, as the engine's do."""
    dev = model.embed.device
    gaps = []
    with torch.inference_mode(), mock.patch.object(
            transformer, "flash_attention", plain_flash):
        for j, (p, n) in enumerate(reqs):
            full = np.concatenate([prefix, p]) if j in carriers else p
            seq = torch.from_numpy(np.concatenate([full, tokens[j][:-1]]))
            seq = seq[None].to(dev)
            cache = decode.init_cache(model, 1, seq.shape[1])
            if over_cache:
                head = prefix.size if j in carriers else p.size
                rest = torch.arange(head, seq.shape[1], dtype=torch.int32,
                                    device=dev)[None]
                logits = torch.cat([model(seq[:, :head], None, cache),
                                    model(seq[:, head:], rest, cache)], 1)
            else:
                logits = model(seq, None, cache)
            rows = logits[0, full.size - 1:]
            emitted = torch.from_numpy(tokens[j]).to(dev, torch.long)
            gaps.append(rows.max(dim=-1).values
                        - rows.gather(1, emitted[:, None])[:, 0])
    return gaps


def tau_gate(tag: str, per_req: list, tau: float, diff: float,
             control: bool = False, every: bool = True,
             mult: float = TAU_MULT, exact_min: float = EXACT_MIN,
             unit: str = "phase 3's") -> None:
    """The teacher-forced gate on one run's per-request gaps: every
    request's worst gap within ``tau`` (``mult`` x ``diff``, the ``unit``
    phase's max|kernel - plain| prefill logits) and at least ``exact_min``
    of all tokens the teacher-forced argmax; a ``control`` run (a planted
    fault) must break both, in every request, or with ``every=False`` be
    rejected by the gate as a whole (either limit broken)."""
    gaps = torch.cat(per_req)
    exact = (gaps == 0).float().mean().item()
    req_max = torch.stack([g.max() for g in per_req])
    caught = int((req_max > tau).sum())
    print(f"{tag} teacher-forced check of {gaps.numel()} tokens: exact "
          f"argmax {int((gaps == 0).sum())} ({exact:.4f}, min "
          f"{exact_min:g}), max gap {gaps.max().item():.4f}, median gap "
          f"{gaps.median().item():.4f}; per request max gap min "
          f"{req_max.min().item():.4f} median "
          f"{req_max.median().item():.4f}, {caught} of {len(per_req)} above "
          f"tau {tau:.4f} = {mult:g} x {unit} max|kernel - plain| "
          f"{diff:.4f}")
    if not control and (caught or exact < exact_min):
        fail(f"{tag} emitted tokens off the teacher-forced maximum (tau "
             f"{tau:.4f}, exact share {exact_min:g})")
    if control and every and (caught < len(per_req) or exact >= exact_min):
        fail(f"{tag} the teacher-forced gate did not catch the planted "
             f"fault in every request")
    if control and not every and not (caught or exact < exact_min):
        fail(f"{tag} the teacher-forced gate did not reject the planted "
             f"fault")


def serve_engine(cfg, params, mods, plain_flash, diff, gpu, serving,
                 transformer, decode) -> dict:
    """Phase 3e: the continuous-batching engine at llama2_7b width, greedy,
    on five engines over the same traffic: (a) dense, (b) paged
    (ENGINE_PAGES pages of 128 tokens), (c) dense with prefill_chunk 256,
    (d) dense with a registered prefix, (e) (a) again. In (c), (d) and (e)
    every flash call is held against the plain attention on its own
    inputs; (a) and (b) are timed. Gates: the flash outputs within the
    bf16 tolerance at every (bucket, batch); (b)'s and (e)'s tokens equal
    (a)'s; every token of (a), (c), (d) within tau of the teacher-forced
    maximum and at least EXACT_MIN of them its argmax, and a control run
    with a planted fault (each decode step's K/V written one position
    late) caught by both in every request; flash launches
    one a layer per fresh prefill (``drive_engine``); every request
    complete; (b)'s pool drained and its null page zero. Prints the times
    of (a) and (b). Returns the launches of (a)-(e) and (a)'s readings."""
    reqs, prefix, carriers = engine_traffic(cfg.vocab_size)
    dev = params["embed"].device
    kinds = {"a": ("dense", {}),
             "b": (f"paged, {ENGINE_PAGES} pages of 128 tokens",
                   {"kv_pages": ENGINE_PAGES, "page_tokens": 128}),
             "c": ("dense, prefill_chunk 256", {"prefill_chunk": 256}),
             "d": (f"dense, a {ENGINE_PREFIX}-token prefix carried by "
                   f"{ENGINE_CARRIERS} requests", {}),
             "e": ("dense, as (a)", {}),
             "control": ("dense, each decode step's K/V written one "
                         "position late (a planted fault)", {})}
    append = transformer._append_per_row

    def late(k, v, positions, cache):
        append(k, v, positions + 1, cache)

    worst: dict = {}     # (bucket, batch) -> max|o - plain| of the flash
    runs = {}
    reset_counts(mods)
    for key, (label, kw) in kinds.items():
        if key == "control":
            launches = read_counts(mods)
        engine = serving.ContinuousBatchingEngine(
            cfg, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
            clock=time.monotonic, device=dev, **kw)
        ctx = (flash_checked(transformer, plain_flash, worst)
               if key in ("c", "d", "e") else
               mock.patch.object(transformer, "_append_per_row", late)
               if key == "control" else nullcontext())
        with ctx:
            run = drive_engine(engine, reqs,
                               prefix if key == "d" else None,
                               carriers if key == "d" else set(), mods,
                               time.monotonic)
        run["pages_in_use"] = engine.pages_in_use
        run["null_page_zero"] = engine.null_page_is_zero()
        runs[key] = run
        print(f"[engine] ({key}) {kinds[key][0]}: {len(run['tokens'])} "
              f"requests, {run['emitted']} tokens, steps "
              f"{engine.stats['steps']}, admitted "
              f"{engine.stats['admitted']}; fresh prefills {run['fresh']} "
              f"(prefix {engine.stats['prefix_prefills']}), prefill "
              f"positions {engine.stats['prefill_positions']}; flash_fwd "
              f"launches {run['launched']['flash_fwd']} = {cfg.n_layers} x "
              f"{run['fresh']}")
        del engine
        torch.cuda.empty_cache()

    tol_o = TOL[torch.bfloat16][0]
    print(f"[engine] flash_fwd against the plain attention on the engine's "
          f"own q, k, v in (c), (d), (e), max|o - plain| by bucket x batch "
          f"(tol {tol_o:g}): " + ", ".join(
              f"{l} x {b}: {e:.3e}" for (l, b), e in sorted(worst.items())))
    if not worst or max(worst.values()) > tol_o:
        fail("the flash forward strays from the plain attention on the "
             "engine's inputs")
    a = runs["a"]["tokens"]
    for key in "be":
        same = all(np.array_equal(a[j], runs[key]["tokens"][j]) for j in a)
        print(f"[engine] ({key}) tokens equal to (a), token for token: "
              f"{same}")
        if not same:
            fail(f"engine ({key})'s tokens differ from the dense engine's")
    b = runs["b"]
    print(f"[engine] (b) pages in use after the run {b['pages_in_use']}, "
          f"null page zero {b['null_page_zero']}")
    if b["pages_in_use"] or not b["null_page_zero"]:
        fail("the paged pool did not drain, or its null page is not zero")

    tau = TAU_MULT * diff
    model = decode.decode_model(
        dataclasses.replace(cfg, max_seq_len=ENGINE_MAX_LEN), params, dev)
    for key in ("a", "c", "d", "control"):
        per_req = teacher_forced_gaps(
            model, reqs, runs[key]["tokens"], prefix,
            carriers if key == "d" else set(), plain_flash, transformer,
            decode)
        tau_gate(f"[engine] ({key})", per_req, tau, diff, key == "control")
    del model

    for key in "ab":
        run = runs[key]
        by_bucket = ", ".join(
            f"{bucket} x {n}: {statistics.median(ms):.2f} ms ({len(ms)})"
            for (bucket, n), ms in sorted(run["prefill_ms"].items()))
        print(f"[time] {gpu}: engine ({key}) {kinds[key][0]}, llama2_7b "
              f"bf16, {ENGINE_SLOTS} slots: decode step at occupancy "
              f"{ENGINE_SLOTS} median {statistics.median(run['step_ms']):.2f} "
              f"ms over {len(run['step_ms'])} steps; prefill by bucket x "
              f"batch (median on CUDA events, calls) {by_bucket}; "
              f"{run['emitted'] / run['wall']:.1f} tokens/s aggregate "
              f"({run['emitted']} tokens in {run['wall']:.2f} s); p50 TTFT "
              f"{statistics.median(run['ttft_ms']):.1f} ms")
    return launches, runs["a"]


def scrape(metrics_mod, metrics) -> dict:
    """Sample name → value of the scrape body ``exposition()`` gives."""
    out = {}
    for line in metrics_mod.exposition(metrics).splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def drive_in_turn(engine, reqs, carriers, pid, migrate=None) -> dict:
    """Phase 3f's monolithic driver: ``reqs`` submitted in order, one a
    step, each only when a slot is free and every earlier request has its
    first token, so that every admission is a batch-1 prefill (the calls a
    ``PrefillJob`` makes). ``migrate(engine, seen)`` may take requests out
    after a step (``seen``: tokens streamed per request). Returns the
    tokens by request and the host times of the steps entered with every
    slot busy (each ends in its copy of tokens to the host)."""
    seen, out, step_ms, j = {}, {}, [], 0
    gone: set = set()

    def on_token(rid, tok):
        seen[rid] = seen.get(rid, 0) + 1

    while len(out) + len(gone) < len(reqs):
        if (j < len(reqs) and engine.free_slots > 0
                and all(seen.get(r, 0) for r in range(j))):
            rid = engine.submit(*reqs[j], on_token=on_token,
                                prefix_id=pid if j in carriers else None)
            if rid != j:
                fail(f"engine request id {rid} for request {j}")
            j += 1
        full = engine.free_slots == 0
        t0 = time.perf_counter()
        for rid in engine.step():
            out[rid] = engine.result(rid)
        if full:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if migrate is not None:
            gone |= migrate(engine, seen)
    return {"tokens": out, "step_ms": step_ms}


def serve_disagg(cfg, params, mods, plain_flash, gpu, serving, transformer,
                 decode, metrics_mod) -> dict:
    """Phase 3f: disaggregated prefill at llama2_7b width on phase 3e's
    traffic, three engines sharing phase 3's parameter tensors. M:
    monolithic, dense, 8 slots x 2048, prefill_chunk 256, driven by
    ``drive_in_turn``. P: the same config, driven only through
    ``start_prefill`` → ``advance`` → ``handoff`` (the prefix's carriers
    suffix-only). D: paged (ENGINE_PAGES pages of 128 tokens), 8 slots,
    adopting every handoff through ``submit_kv``; its prefix comes from P by
    ``export_prefix`` / ``import_prefix``. Gates: every handoff verifies and
    fails with one byte flipped, at pb x HANDOFF_BYTES_PER_POSITION bytes;
    D's tokens equal M's for all requests; D runs no prefill and launches
    no flash_fwd, P launches it once a layer per fresh prefill; a second run
    of M hands DISAGG_MIGRATED requests to D mid-decode (``export_kv``,
    ``abort``, ``submit_kv``) and every output equals the first run's; a
    descendant prefix imported over its DISAGG_ANCESTOR-token ancestor
    aliases the ancestor's pages and serves a request as D's own
    registered prefix does; the metrics read through ``exposition()`` count
    what the engines saw, D's pool drains with page 0 zero; every flash call
    of M, of M's second run and of the prefix section held against the
    plain attention on its own inputs within phase 3e's bf16 tolerance, and
    every (bucket, batch) that P's timed prefills launch among those
    checked. Prints the handoff bytes and times and both engines' decode
    step at occupancy 8. Returns the phase's launches."""
    reqs, prefix, carriers = engine_traffic(cfg.vocab_size)
    dev = params["embed"].device
    shape = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                 clock=time.monotonic, device=dev)
    client = metrics_mod._prom is not None
    # built as without prometheus_client (which this machine may carry):
    # the gate reads the body exposition() renders without it
    with mock.patch.object(metrics_mod, "_prom", None):
        m_metrics = metrics_mod.ServingMetrics()
        d_metrics = metrics_mod.ServingMetrics()
        d_kv_metrics = metrics_mod.PagedKVMetrics()
    M = serving.ContinuousBatchingEngine(cfg, params, prefill_chunk=256,
                                         metrics=m_metrics, **shape)
    P = serving.ContinuousBatchingEngine(cfg, params, prefill_chunk=256,
                                         **shape)
    D = serving.ContinuousBatchingEngine(
        cfg, params, kv_pages=ENGINE_PAGES, page_tokens=128,
        metrics=d_metrics, kv_metrics=d_kv_metrics, **shape)
    shared = all(t.data_ptr() == params[n].data_ptr()
                 for e in (M, P, D)
                 for model in (e._prefill_model, e._step_model)
                 for n, t in model.named_parameters())
    print(f"[disagg] engines M (dense, prefill_chunk 256), P (the same, "
          f"prefill only) and D (paged, {ENGINE_PAGES} pages of 128), "
          f"{ENGINE_SLOTS} slots x {ENGINE_MAX_LEN}; every model holds phase "
          f"3's parameter tensors themselves: {shared}; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the "
          f"card; prometheus_client {'present' if client else 'absent'} "
          f"here, the metrics built without it")
    if not shared:
        fail("the engines copied the parameters")
    reset_counts(mods)

    # ---- M: the monolithic reference run, every flash call checked (its
    # timed steps, entered with every slot busy, admit nothing and so run
    # no flash call)
    worst: dict = {}     # (bucket, batch) -> max|o - plain| of the flash
    with flash_checked(transformer, plain_flash, worst):
        pid_m = M.register_prefix(prefix)
        mono = drive_in_turn(M, reqs, carriers, pid_m)
    m_tokens = mono["tokens"]

    # ---- P → D: every request prefilled on P, adopted by D. P's prefills
    # are timed, so its flash calls are not checked in place; their
    # (bucket, batch) shapes are kept and must be among those checked.
    kernel = transformer.flash_attention
    p_shapes: set = set()

    def recorded(q, k, v, causal=True, segments=None):
        p_shapes.add((q.shape[1], q.shape[0]))
        return kernel(q, k, v, causal, segments)

    recording = mock.patch.object(transformer, "flash_attention", recorded)
    recording.start()
    pid_p = P.register_prefix(prefix)
    pid_d = D.import_prefix(*P.export_prefix(pid_p))
    timing = {name: [] for name in ("prefill", "export", "seal", "verify",
                                    "adopt")}
    seal = serving.KVHandoff.seal

    def timed_seal(self):
        t0 = time.perf_counter()
        out = seal(self)
        timing["seal"].append((time.perf_counter() - t0) * 1e3)
        return out

    p_flash = 0
    handoffs = []
    for j, (prompt, _) in enumerate(reqs):
        before = mods["fa"].launches
        t0 = time.perf_counter()
        job = P.start_prefill(prompt, pid_p if j in carriers else None)
        while not job.advance():
            pass
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p_flash += mods["fa"].launches - before
        with mock.patch.object(serving.KVHandoff, "seal", timed_seal):
            h = job.handoff(suffix_only=j in carriers)
        timing["prefill"].append((t1 - t0) * 1e3)
        timing["export"].append((time.perf_counter() - t1) * 1e3
                                - timing["seal"][-1])
        t0 = time.perf_counter()
        ok = h.verify()
        timing["verify"].append((time.perf_counter() - t0) * 1e3)
        byte = h.cache["k"].view(torch.uint8).view(-1)
        byte[0] ^= 0xFF
        caught = not h.verify()
        byte[0] ^= 0xFF            # restored: the byte D adopts is sound
        pb = decode._bucket_len(h.pos, ENGINE_MAX_LEN)
        if (not ok or not caught
                or h.nbytes != pb * HANDOFF_BYTES_PER_POSITION
                or h.base != (ENGINE_PREFIX if j in carriers else 0)):
            fail(f"handoff {j}: verify {ok}, flipped byte caught {caught}, "
                 f"{h.nbytes} bytes at bucket {pb}, base {h.base}")
        handoffs.append(h)
    recording.stop()
    adopt = D._adopt_into_slot

    def timed_adopt(*args, **kw):
        t0 = time.perf_counter()
        adopt(*args, **kw)
        torch.cuda.synchronize()
        timing["adopt"].append((time.perf_counter() - t0) * 1e3)

    d_ids = {}
    for j, h in enumerate(handoffs):
        d_ids[D.submit_kv(h, reqs[j][1],
                          prefix_id=pid_d if j in carriers else None)] = j
    d_out, d_step_ms, d_flash = {}, [], 0
    with mock.patch.object(D, "_adopt_into_slot", timed_adopt):
        while len(d_out) < len(reqs):
            full = D.free_slots == 0
            before = mods["fa"].launches
            t0 = time.perf_counter()
            for rid in D.step():
                d_out[d_ids[rid]] = D.result(rid)
            if full:
                d_step_ms.append((time.perf_counter() - t0) * 1e3)
            d_flash += mods["fa"].launches - before
    same = [j for j in range(len(reqs))
            if np.array_equal(d_out[j], m_tokens[j])]
    print(f"[disagg] D's tokens equal M's, token for token, in {len(same)} "
          f"of {len(reqs)} requests ({sum(len(t) for t in d_out.values())} "
          f"tokens)")
    if len(same) != len(reqs):
        fail(f"D's tokens differ from M's in requests "
             f"{sorted(set(range(len(reqs))) - set(same))}")
    print(f"[disagg] D: prefill positions {D.stats['prefill_positions']}, "
          f"flash_fwd launches {d_flash}, adopted {D.stats['kv_adopted']}; "
          f"P: fresh prefills {P.stats['fresh_prefills']} (the prefix's "
          f"included), flash_fwd launches {p_flash} + {cfg.n_layers} for its "
          f"prefix; every handoff verified and failed with one byte flipped")
    if (D.stats["prefill_positions"] or d_flash
            or D.stats["kv_adopted"] != len(reqs)
            or p_flash != cfg.n_layers * (P.stats["fresh_prefills"] - 1)):
        fail("the decode engine prefilled, or the prefill engine's flash "
             "launches are not one a layer per fresh prefill")
    mib = [h.nbytes / 2**20 for h in handoffs]
    print(f"[disagg] handoff bytes a request: pb x "
          f"{HANDOFF_BYTES_PER_POSITION:,} B (32 layers x K, V x 8 kv heads "
          f"x 128 x 2 B), {min(mib):.0f}-{max(mib):.0f} MiB, "
          f"{sum(mib) / 2**10:.2f} GiB in all")
    for j, h in enumerate(handoffs):
        print(f"[time] {gpu}: handoff {j}: pos {h.pos} pb "
              f"{decode._bucket_len(h.pos, ENGINE_MAX_LEN)} base {h.base} "
              f"{h.nbytes / 2**20:.0f} MiB; P prefill "
              f"{timing['prefill'][j]:.2f} ms, export (device → host) "
              f"{timing['export'][j]:.2f} ms, seal {timing['seal'][j]:.2f} "
              f"ms, verify {timing['verify'][j]:.2f} ms, submit_kv → "
              f"adoption (host → device, splice) "
              f"{timing['adopt'][j]:.2f} ms")
    by_pb: dict = {}
    for j, h in enumerate(handoffs):
        pb = decode._bucket_len(h.pos, ENGINE_MAX_LEN)
        by_pb.setdefault(pb, []).append(j)
    print(f"[time] {gpu}: handoff medians by bucket (export / seal / verify "
          f"/ adoption / P prefill, ms): " + "; ".join(
              f"{pb} x {len(js)}: " + " / ".join(
                  f"{statistics.median(timing[k][j] for j in js):.2f}"
                  for k in ("export", "seal", "verify", "adopt", "prefill"))
              for pb, js in sorted(by_pb.items())))
    print(f"[time] {gpu}: decode step at occupancy {ENGINE_SLOTS}, llama2_7b "
          f"bf16: D (paged, adopted) median "
          f"{statistics.median(d_step_ms):.2f} ms over {len(d_step_ms)} "
          f"steps; M (dense, monolithic) median "
          f"{statistics.median(mono['step_ms']):.2f} ms over "
          f"{len(mono['step_ms'])} steps")

    # ---- migration: a second run of M hands requests to D mid-decode;
    # from here to the metrics every flash call is checked
    checking = flash_checked(transformer, plain_flash, worst)
    checking.start()
    M2 = serving.ContinuousBatchingEngine(cfg, params, prefill_chunk=256,
                                          **shape)
    migrated = {}

    def migrate(engine, seen):
        if migrated:
            return set()
        live = [r for r, n in sorted(seen.items())
                if 2 <= n <= reqs[r][1] - 2]
        if len(live) < DISAGG_MIGRATED:
            return set()
        for r in live[:DISAGG_MIGRATED]:
            h = engine.export_kv(r)
            left = engine.abort(r)
            if (h is None or not h.verify() or left is None
                    or list(left) != list(h.emitted)):
                fail(f"request {r} did not export and abort mid-decode")
            migrated[r] = h
        return set(migrated)

    pid_m2 = M2.register_prefix(prefix)
    rerun = drive_in_turn(M2, reqs, carriers, pid_m2, migrate)["tokens"]
    if len(migrated) != DISAGG_MIGRATED:
        fail(f"{len(migrated)} requests migrated")
    moved = {D.submit_kv(h, reqs[r][1]): r for r, h in migrated.items()}
    for rid, toks in D.run().items():
        rerun[moved[rid]] = toks
    same = all(np.array_equal(rerun[j], m_tokens[j]) for j in range(len(reqs)))
    print(f"[disagg] migration: M's second run moved requests "
          f"{sorted(migrated)} to D after "
          f"{[len(migrated[r].emitted) for r in sorted(migrated)]} tokens "
          f"(export_kv, abort, submit_kv); all {len(reqs)} outputs equal the "
          f"first run's: {same}")
    if not same:
        fail("a migrated or repeated request's tokens differ")
    del M2

    # ---- prefix export and import with a base-aliased descendant
    anc = prefix[:DISAGG_ANCESTOR]
    anc_export = P.export_prefix(P.register_prefix(anc))
    pid_anc = D.import_prefix(*anc_export)
    aliased, allocated = D.stats["pages_aliased"], D.stats["pages_allocated"]
    pid_desc = D.import_prefix(*P.export_prefix(pid_p), base_pid=pid_anc,
                               base_len=DISAGG_ANCESTOR)
    new_alias = D.stats["pages_aliased"] - aliased
    new_pages = D.stats["pages_allocated"] - allocated
    # a carrier whose suffix M prefilled whole (no chunk), as D does
    j0 = min(j for j in carriers if reqs[j][0].size <= 256)
    r_imp = D.submit(reqs[j0][0], reqs[j0][1], prefix_id=pid_desc)
    imported = D.run()[r_imp]
    pid_own = D.register_prefix(prefix)
    r_own = D.submit(reqs[j0][0], reqs[j0][1], prefix_id=pid_own)
    own = D.run()[r_own]
    print(f"[disagg] import_prefix of the {ENGINE_PREFIX}-token prefix over "
          f"its {DISAGG_ANCESTOR}-token ancestor on D: {new_alias} pages "
          f"aliased, {new_pages} written; request {j0} under it equals the "
          f"same under D's own registered prefix: "
          f"{np.array_equal(imported, own)}, and M's: "
          f"{np.array_equal(own, m_tokens[j0])}")
    if (new_alias != DISAGG_ANCESTOR // 128
            or new_pages != ENGINE_PREFIX // 128 - DISAGG_ANCESTOR // 128
            or not np.array_equal(imported, own)
            or not np.array_equal(own, m_tokens[j0])):
        fail("the descendant prefix did not alias its ancestor's pages or "
             "serve as D's own prefix does")
    checking.stop()
    tol_o = TOL[torch.bfloat16][0]
    unchecked = sorted(p_shapes - set(worst))
    print(f"[disagg] flash_fwd against the plain attention on the engines' "
          f"own q, k, v in M, M's second run and the prefix section, "
          f"max|o - plain| by bucket x batch (tol {tol_o:g}): " + ", ".join(
              f"{l} x {b}: {e:.3e}" for (l, b), e in sorted(worst.items()))
          + f"; P's bucket x batch {sorted(p_shapes)}, unchecked "
          f"{unchecked}")
    if not worst or max(worst.values()) > tol_o:
        fail("the flash forward strays from the plain attention on phase "
             "3f's inputs")
    if unchecked:
        fail(f"P launched flash_fwd at bucket x batch {unchecked}, which no "
             f"checked call covered")

    # ---- the metrics, read through the scrape body
    for pid in (pid_d, pid_anc, pid_desc, pid_own):
        D.drop_prefix(pid)
    m_scrape = scrape(metrics_mod, m_metrics)
    d_scrape = scrape(metrics_mod, d_metrics)
    kv_scrape = scrape(metrics_mod, d_kv_metrics)
    d_seen = len(reqs) + len(migrated) + 2
    d_tokens = (sum(len(t) - len(h.emitted)
                    for t, h in zip((d_out[j] for j in range(len(reqs))),
                                    handoffs))
                + sum(len(rerun[r]) - len(h.emitted)
                      for r, h in migrated.items())
                + len(imported) + len(own))
    ns, paged = "tpu_on_k8s_serving_", "tpu_on_k8s_paged_"
    want = {
        "M": (m_scrape, len(reqs), len(reqs),
              sum(len(t) for t in m_tokens.values()), len(reqs)),
        "D": (d_scrape, d_seen, d_seen, d_tokens, 2)}
    for name, (s, *counts) in want.items():
        got = tuple(int(s[ns + key]) for key in (
            "requests_submitted_total", "requests_finished_total",
            "tokens_emitted_total", "time_to_first_token_seconds_count"))
        print(f"[disagg] {name}'s ServingMetrics through exposition(): "
              f"submitted, finished, tokens emitted, TTFT observations "
              f"{got} (want {tuple(counts)}; an adopted handoff observes no "
              f"TTFT, as in the reference)")
        if got != tuple(counts):
            fail(f"{name}'s serving metrics miscount")
    p50 = {name: statistics.median(m_metrics.histograms[name]) * 1e3
           for name in ("time_to_first_token_seconds",
                        "request_latency_seconds")}
    print(f"[time] {gpu}: M's p50 TTFT "
          f"{p50['time_to_first_token_seconds']:.1f} ms, p50 latency "
          f"{p50['request_latency_seconds']:.1f} ms (its ServingMetrics, "
          f"engine clock)")
    kv_got = (kv_scrape[paged + "pages_total"],
              kv_scrape[paged + "pages_in_use"],
              kv_scrape[paged + "page_allocs_total"],
              kv_scrape[paged + "pages_aliased_total"],
              kv_scrape[paged + "programs_compiled_total"])
    kv_want = (ENGINE_PAGES, 0, D.stats["pages_allocated"],
               D.stats["pages_aliased"], 0)
    print(f"[disagg] D's PagedKVMetrics through exposition(): pages total, "
          f"in use, allocated, aliased, programs compiled "
          f"{tuple(int(v) for v in kv_got)} (want {kv_want}); page 0 zero "
          f"{D.null_page_is_zero()}")
    if kv_got != kv_want or not D.null_page_is_zero():
        fail("D's paged metrics miscount, or its pool did not drain")
    launched = read_counts(mods)
    del M, P, D
    torch.cuda.empty_cache()
    return launched


def serve_spec(cfg, params, w8_tree, mods, plain_flash, diff, gpu, plain_a,
               serving, transformer, decode, chaos_mod) -> dict:
    """Phase 3g: speculative decoding at llama2_7b width on phase 3e's
    weights and its first SPEC_REQUESTS requests, SPEC_K proposals a round,
    8 slots x 2048. Engines:
    (a) dense, the target itself as the draft; (b) dense, its first
    SPEC_DRAFT_LAYERS layers (``truncated_draft``: the target's tensors) as
    the draft, with the ENGINE_PREFIX-token prefix carried by the requests
    that carry it in 3e and mirrored through the draft; (c) (b) on the
    paged pool; (d) (b) under ``spec_draft_crash(at_round=2)``; (e)
    ``speculative_generate`` at batch 1 with both drafts; (f) the W8A16
    tree of phase 3b as the target of (b)'s bf16 draft, SPEC_W8_REQUESTS
    requests. Gates: every request complete; (a) accepts some proposals,
    (b) rolls some back, its draft's tensors are the target's; (c)'s tokens
    equal (b)'s and its pool drains with page 0 zero; (d) crashes once on
    round 2 and finishes on the plain step; every token of (a), (b), (d),
    (e) within tau of a teacher-forced maximum of the bf16 model on the
    plain attention, of (f) of the W8 model's and of the fp32 model of its
    dequantized weights, at least EXACT_MIN of them its argmax; a control
    run of (b) with its verify's K/V written one
    position late caught in every request; flash_fwd launches once a target
    layer per fresh prefill and once a draft layer per fresh draft seed;
    every flash call of (b) within 3e's bf16 tolerance of the plain
    attention. Prints round times (draft and verify), acceptance, tokens a
    round, tokens/s and TTFT beside 3e (a)'s plain run, and (e)'s ms a
    token beside plain ``generate``'s. Returns the launches of (a)-(f)."""
    reqs, prefix, carriers = engine_traffic(cfg.vocab_size)
    reqs = reqs[:SPEC_REQUESTS]
    carriers = {j for j in carriers if j < SPEC_REQUESTS}
    dev = params["embed"].device
    dcfg, dparams = decode.truncated_draft(cfg, params, SPEC_DRAFT_LAYERS)
    drafts = {"self": (cfg, params), "layers": (dcfg, dparams)}
    shape = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                 clock=time.monotonic, device=dev, spec_k=SPEC_K)
    tau = TAU_MULT * diff
    kinds = {
        "a": ("dense, the target itself as the draft", "self", {}),
        "b": (f"dense, its first {SPEC_DRAFT_LAYERS} layers as the draft, "
              f"the {ENGINE_PREFIX}-token prefix carried by "
              f"{len(carriers)} requests", "layers", {}),
        "c": (f"paged, {ENGINE_PAGES} pages of 128, as (b)", "layers",
              {"kv_pages": ENGINE_PAGES, "page_tokens": 128}),
        "d": ("(b) under chaos.spec_draft_crash(at_round=2)", "layers", {}),
        "control": ("(b) with its verify's K/V written one position late "
                    "(a planted fault)", "layers", {})}
    append = transformer._append_per_row

    def late(k, v, positions, cache):
        append(k, v, positions + 1, cache)

    worst: dict = {}     # (bucket, batch) -> max|o - plain| of (b)'s flash
    runs = {}

    def serve(key):
        label, draft, kw = kinds[key]
        rounds: list = []
        engine = serving.ContinuousBatchingEngine(
            cfg, params, draft_cfg=drafts[draft][0],
            draft_params=drafts[draft][1],
            on_spec_round=lambda *r: rounds.append(r), **shape, **kw)
        runner = engine._draft
        if key == "b":
            models = (runner._prefill_model, runner._step_model)
            aliased = all(t.data_ptr() == params[n].data_ptr()
                          for m in models for n, t in m.named_parameters())
            print(f"[spec] (b) the draft's {len(dparams)} tensors are the "
                  f"target's own (data_ptr equal in both draft models): "
                  f"{aliased}")
            if not aliased:
                fail("the truncated draft copied the target's weights")
        if key == "control":
            verify = engine._verify

            def faulty(chunk, cpos):
                with mock.patch.object(transformer, "_append_per_row", late):
                    return verify(chunk, cpos)

            engine._verify = faulty
        ctx = (flash_checked(transformer, plain_flash, worst)
               if key == "b" else
               chaos_mod.spec_draft_crash(at_round=2).injector()
               if key == "d" else nullcontext())
        with ctx, warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            run = drive_engine(engine, reqs,
                               None if key == "a" else prefix,
                               set() if key == "a" else carriers, mods,
                               time.monotonic, draft=runner)
        st = run["stats"] = dict(engine.stats)
        if run["pid"] is not None:
            engine.drop_prefix(run["pid"])
        run.update(rounds=rounds, seeds=runner.fresh_prefills,
                   warned=[str(w.message) for w in warned],
                   pages_in_use=engine.pages_in_use,
                   null_page_zero=engine.null_page_is_zero())
        runs[key] = run
        print(f"[spec] ({key}) {label}: {len(run['tokens'])} requests, "
              f"{run['emitted']} tokens, steps {st['steps']}, spec rounds "
              f"{st['spec_rounds']}, proposed {st['spec_proposed']}, "
              f"accepted {st['spec_accepted']} (acceptance "
              f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.4f}), "
              f"rollbacks {st['spec_rollbacks']}, draft crashes "
              f"{st['draft_crashes']}; flash_fwd launches "
              f"{run['launched']['flash_fwd']} = {cfg.n_layers} x "
              f"{run['fresh']} fresh target prefills + "
              f"{runner._prefill_model.cfg.n_layers} x {run['seeds']} fresh "
              f"draft seeds (a suffix seed after the mirrored prefix "
              f"launches none)")
        del engine, runner
        torch.cuda.empty_cache()

    reset_counts(mods)
    for key in "abcd":
        serve(key)
    a, b, c, d = (runs[key] for key in "abcd")
    if a["stats"]["spec_accepted"] <= 0:
        fail("the self-draft engine accepted no proposal")
    if b["stats"]["spec_rollbacks"] <= 0:
        fail("the truncated draft was never rolled back")
    same = all(np.array_equal(b["tokens"][j], c["tokens"][j])
               for j in b["tokens"])
    print(f"[spec] (c) tokens equal to (b)'s, request for request: {same}; "
          f"pages in use after the run {c['pages_in_use']}, null page zero "
          f"{c['null_page_zero']}")
    if not same:
        fail("the paged speculative engine's tokens differ from the dense "
             "one's")
    if c["pages_in_use"] or not c["null_page_zero"]:
        fail("the paged pool did not drain, or its null page is not zero")
    ds = d["stats"]
    print(f"[spec] (d) draft crashes {ds['draft_crashes']}, spec rounds "
          f"{ds['spec_rounds']}, then {ds['steps'] - ds['spec_rounds']} plain "
          f"steps; warned: {d['warned']}")
    if (ds["draft_crashes"] != 1 or not 1 <= ds["spec_rounds"] <= 2
            or ds["steps"] <= ds["spec_rounds"] or not d["warned"]):
        fail("the draft crash did not degrade the engine to the plain step "
             "on round 2")
    tol_o = TOL[torch.bfloat16][0]
    print(f"[spec] (b) flash_fwd against the plain attention on the engine's "
          f"own q, k, v (target prefills and draft seeds), max|o - plain| by "
          f"bucket x batch (tol {tol_o:g}): " + ", ".join(
              f"{l} x {n}: {e:.3e}" for (l, n), e in sorted(worst.items())))
    if not worst or max(worst.values()) > tol_o:
        fail("the flash forward strays from the plain attention on phase "
             "3g's inputs")
    for key in "abc":
        run, st = runs[key], runs[key]["stats"]
        slot_rounds = st["spec_proposed"] // SPEC_K
        in_rounds = run["emitted"] - len(reqs)    # less admissions' firsts
        print(f"[time] {gpu}: spec ({key}) {kinds[key][0]}, llama2_7b bf16, "
              f"{ENGINE_SLOTS} slots, k {SPEC_K}"
              f"{', flash calls checked' if key == 'b' else ''}: round at "
              f"occupancy {ENGINE_SLOTS} median "
              f"{median(run['step_ms']):.2f} ms over "
              f"{len(run['step_ms'])}; a round's draft median "
              f"{statistics.median(r[1] for r in run['rounds']) * 1e3:.2f} "
              f"ms + verify median "
              f"{statistics.median(r[2] for r in run['rounds']) * 1e3:.2f} "
              f"ms (engine clock; in all spec_draft_s "
              f"{st['spec_draft_s']:.3f} s, spec_verify_s "
              f"{st['spec_verify_s']:.3f} s over {st['spec_rounds']} "
              f"rounds); acceptance "
              f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.4f}; "
              f"tokens a round {in_rounds / st['spec_rounds']:.2f}, a "
              f"slot-round {in_rounds / max(slot_rounds, 1):.3f}; "
              f"{run['emitted'] / run['wall']:.1f} tokens/s aggregate, p50 "
              f"TTFT {statistics.median(run['ttft_ms']):.1f} ms; 3e (a) "
              f"plain dense: {plain_a['emitted'] / plain_a['wall']:.1f} "
              f"tokens/s, p50 TTFT "
              f"{statistics.median(plain_a['ttft_ms']):.1f} ms, decode step "
              f"at occupancy {ENGINE_SLOTS} "
              f"{statistics.median(plain_a['step_ms']):.2f} ms")

    # ---- (e) speculative_generate at batch 1
    pgen = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, SPEC_B1_PROMPT),
                           generator=pgen, device=dev, dtype=torch.int32)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    b1 = {}
    for key, (dc, dp) in drafts.items():
        before = mods["fa"].launches
        (toks, st), first_ms = timed(lambda: decode.speculative_generate(
            cfg, params, dc, dp, prompt, SPEC_B1_NEW, k=SPEC_K, device=dev))
        flash = mods["fa"].launches - before
        if (tuple(toks.shape) != (1, SPEC_B1_NEW)
                or flash != cfg.n_layers + dc.n_layers):
            fail(f"speculative_generate ({key}): tokens {tuple(toks.shape)}, "
                 f"flash_fwd launches {flash}")
        b1[key] = (toks[0].cpu().numpy(), st, first_ms)
        print(f"[spec] (e) speculative_generate, draft {key} "
              f"({dc.n_layers} layers), batch 1 x prompt {SPEC_B1_PROMPT} -> "
              f"{SPEC_B1_NEW}, k {SPEC_K}: rounds {st['rounds']}, acceptance "
              f"{st['acceptance_rate']:.4f}, tokens per target forward "
              f"{st['tokens_per_target_forward']:.3f}; flash_fwd launches "
              f"{flash} = {cfg.n_layers} + {dc.n_layers} (the two prefills)")

    # ---- (f) the W8A16 tree as the target of the bf16 draft
    wcfg, wparams = w8_tree
    w8_reqs = reqs[:SPEC_W8_REQUESTS]
    engine = serving.ContinuousBatchingEngine(
        wcfg, wparams, draft_cfg=dcfg, draft_params=dparams, **shape)
    w8_run = drive_engine(engine, w8_reqs, None, set(), mods,
                          time.monotonic, draft=engine._draft)
    st = engine.stats
    print(f"[spec] (f) W8A16 target (phase 3b's tree), bf16 "
          f"{SPEC_DRAFT_LAYERS}-layer draft, dense: "
          f"{len(w8_run['tokens'])} requests, {w8_run['emitted']} tokens, "
          f"spec rounds {st['spec_rounds']}, acceptance "
          f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.4f}")
    del engine
    launches = read_counts(mods)

    # ---- off the path: the control, plain generate's time, the gates
    serve("control")
    for _ in range(2):      # the second call is timed
        plain_ms = timed(lambda: decode.generate(cfg, params, prompt,
                                                 SPEC_B1_NEW, device=dev))[1]
    for key, (dc, dp) in drafts.items():
        (_, st2), ms = timed(lambda: decode.speculative_generate(
            cfg, params, dc, dp, prompt, SPEC_B1_NEW, k=SPEC_K, device=dev))
        if st2 != b1[key][1]:
            fail(f"speculative_generate ({key}) repeated: stats {st2}, "
                 f"first {b1[key][1]}")
        print(f"[time] {gpu}: (e) speculative_generate, draft {key}, "
              f"llama2_7b bf16, batch 1 x {SPEC_B1_PROMPT} -> {SPEC_B1_NEW}: "
              f"{ms:.1f} ms, {ms / SPEC_B1_NEW:.2f} ms a token, prefill "
              f"included (first call {b1[key][2]:.1f} ms); plain generate "
              f"{plain_ms:.1f} ms, {plain_ms / SPEC_B1_NEW:.2f} ms a token")
    model = decode.decode_model(
        dataclasses.replace(cfg, max_seq_len=ENGINE_MAX_LEN), params, dev)
    for key in ("a", "b", "d", "control"):
        per_req = teacher_forced_gaps(
            model, reqs, runs[key]["tokens"], prefix,
            set() if key == "a" else carriers, plain_flash, transformer,
            decode)
        tau_gate(f"[spec] ({key})", per_req, tau, diff, key == "control")
    print("[spec] (c) holds (b)'s tokens, so (b)'s check covers it")
    b1_reqs = [(prompt[0].cpu().numpy(), SPEC_B1_NEW)]
    for key, (toks, _, _) in b1.items():
        tau_gate(f"[spec] (e) draft {key}", teacher_forced_gaps(
            model, b1_reqs, {0: toks}, prefix, set(), plain_flash,
            transformer, decode), tau, diff)
    del model
    wmodel = decode.decode_model(
        dataclasses.replace(wcfg, max_seq_len=ENGINE_MAX_LEN), wparams, dev)
    tau_gate("[spec] (f) against the W8 model", teacher_forced_gaps(
        wmodel, w8_reqs, w8_run["tokens"], prefix, set(), plain_flash,
        transformer, decode), tau, diff)
    del wmodel
    f32 = decode.decode_model(
        dataclasses.replace(cfg, dtype=torch.float32,
                            max_seq_len=ENGINE_MAX_LEN),
        dequantized(wparams), dev)
    tau_gate("[spec] (f) against the fp32 model of its dequantized "
             "weights (phase 3b's reference)", teacher_forced_gaps(
                 f32, w8_reqs, w8_run["tokens"], prefix, set(), plain_flash,
                 transformer, decode), tau, diff)
    del f32
    torch.cuda.empty_cache()
    return launches


def cache_nbytes(decode, cfg, batch: int, length: int) -> int:
    """The bytes of a cache of ``cfg``'s leaves (``decode.cache_shapes``)
    for ``batch`` rows of ``length`` positions."""
    shapes = decode.cache_shapes(types.SimpleNamespace(cfg=cfg), batch,
                                 length)
    return sum(math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
               for shape, dtype in shapes.values())


def serve_kv_int8(cfg, params, prompt4, greedy, bf16_ms, mods, plain_flash,
                  diff, gpu, plain_a, serving, transformer, decode) -> dict:
    """Phase 3h: the int8 KV cache (``cache_int8``) at llama2_7b width on
    phase 3's weights. (a) ``generate`` batch 4 x 512 -> 64 greedy off the
    int8 cache beside phase 3's bf16-cache run: its prefill (flash over the
    unquantized K, V, every call held against the plain attention) launches
    flash_fwd once a layer, its prefill logits equal the bf16 cache's
    exactly, and one decode step teacher-forced off it stays within
    KV8_NOISE_MULT x the bf16 cache's distance from an fp32 model's step.
    (b) ``quantize_kv`` of the K and V that (a)'s bf16 prefill wrote, on
    the card and on the CPU: int8 values and scales bit for bit, and equal
    to what the int8 prefill stored. (c) phase 3e's first KV8_REQUESTS
    requests with its prefix, dense and paged (ENGINE_PAGES x 128): paged
    tokens equal dense, every token within 3e's tau gate of the
    teacher-forced maximum of the same int8-cache model fed as the engine
    feeds its cache (``teacher_forced_gaps(over_cache=True)``), and a
    control with each decode step's K/V written one position late rejected
    by that gate (8 requests are too few to ask it of each, as 3e does of
    24: one short request's worst gap stayed under tau); flash launches one a layer per fresh
    prefill, the paged pool drained with page 0 zero; the pools' bytes
    against bf16's and the decode step at occupancy 8 printed. (d)
    request KV8_HANDOFF_REQUEST handed off at bucket 1024 from the dense
    engine (``start_prefill``) to the paged one: its bytes, export, seal,
    verify and adoption times, a flipped scale byte caught, and its tokens
    equal to the dense engine's own batch-1 admission of it (M). Returns
    the launches of (a), (c) and (d)."""
    dev = params["embed"].device
    cfg8 = dataclasses.replace(cfg, cache_int8=True)
    t_phase = time.perf_counter()

    # ---- (a) generate off the int8 cache
    worst: dict = {}
    reset_counts(mods)
    with flash_checked(transformer, plain_flash, worst):
        tokens8 = decode.generate(cfg8, params, prompt4, 64)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    err = max(worst.values())
    same = (tokens8 == greedy).float().mean().item()
    print(f"[kv_int8] (a) generate, batch 4 x prompt 512 -> 64 greedy off "
          f"the int8 cache: flash_fwd launches {launches['flash_fwd']} (= "
          f"{cfg.n_layers} layers x 1 prefill), max|o - plain| {err:.3e} "
          f"(tol {TOL[torch.bfloat16][0]:g}); tokens equal to the bf16 "
          f"cache's run in {same:.4f} of positions; row 0: "
          f"{tokens8[0, :16].tolist()} ...")
    if (launches["flash_fwd"] != cfg.n_layers
            or any(c for name, c in launches.items() if name != "flash_fwd")
            or err > TOL[torch.bfloat16][0]):
        fail(f"int8-cache generate launches {launches}, flash error {err}")
    if (tuple(tokens8.shape) != (4, 64) or int(tokens8.min()) < 0
            or int(tokens8.max()) >= cfg.vocab_size):
        fail(f"int8-cache tokens {tuple(tokens8.shape)} out of range")

    # the prefill and one decode step teacher-forced (the bf16 cache's first
    # token) off the bf16 cache, the int8 cache and an fp32 model of the
    # same weights with an fp32 cache, on the plain attention
    bucket = decode._bucket_len(512 + 64, cfg.max_seq_len)
    step_pos = torch.full((4, 1), 512, dtype=torch.int32, device=dev)
    logits, leaves = {}, {}
    with torch.inference_mode():
        for key, kw, weights in (
                ("bf16", {}, params), ("int8", {"cache_int8": True}, params),
                ("fp32", {"dtype": torch.float32},
                 {name: p.float() for name, p in params.items()})):
            model = decode.decode_model(dataclasses.replace(
                cfg, max_seq_len=bucket, **kw), weights, dev)
            leaves[key] = decode.zeros_like_shapes(
                decode.cache_shapes(model, 4), dev)
            cache = decode.layer_caches(leaves[key])
            with (mock.patch.object(transformer, "flash_attention",
                                    plain_flash)
                  if key == "fp32" else nullcontext()):
                pre = model(prompt4, None, cache)
            logits[key] = (pre, model(greedy[:, :1], step_pos, cache))
            del model, cache, weights
    del leaves["fp32"]
    torch.cuda.synchronize()
    pre_same = torch.equal(logits["int8"][0], logits["bf16"][0])
    steps = {key: step for key, (_, step) in logits.items()}
    top = steps["bf16"].abs().max().item()
    dist = {key: (steps[key] - steps["fp32"]).abs().max().item()
            for key in ("bf16", "int8")}
    rel = (steps["int8"] - steps["bf16"]).abs().max().item() / top
    agree = (steps["int8"].argmax(-1) == steps["bf16"].argmax(-1)
             ).float().mean().item()
    print(f"[kv_int8] (a) prefill logits [4, 512, {cfg.vocab_size}] off the "
          f"int8 cache equal the bf16 cache's bit for bit: {pre_same}; one "
          f"decode step teacher-forced off each cache, against the fp32 "
          f"model's: max|int8 - fp32| {dist['int8']:.4f} (tol "
          f"{KV8_NOISE_MULT:g} x bf16 noise {dist['bf16']:.4f} = max|bf16 - "
          f"fp32|; ratio {dist['int8'] / dist['bf16']:.3f}); max|int8 - "
          f"bf16| / max|bf16| {rel:.4e} (the reference's tiny oracle asks "
          f"< 0.05; bf16 against fp32 here {dist['bf16'] / top:.4e}); "
          f"argmax agreement int8/bf16 {agree:.2f}")
    if not pre_same or dist["int8"] > KV8_NOISE_MULT * dist["bf16"]:
        fail("the int8 cache's prefill logits differ from the bf16 cache's, "
             "or its decode step strays beyond its noise bound")
    del logits, pre, steps

    # ---- (b) the quantizer, on the card and on the CPU
    for name in ("k", "v"):
        x = leaves["bf16"][name][:, :, :512]          # bf16, as written
        q_dev, s_dev = transformer.quantize_kv(x)
        q_cpu, s_cpu = transformer.quantize_kv(x.cpu())
        true_div = x.float().abs().amax(-1) / torch.tensor(
            127.0, device=dev)
        stored_q = leaves["int8"][name][:, :, :512]
        stored_s = leaves["int8"][f"{name}_scale"][:, :, :512]
        checks = {
            "card = CPU": (torch.equal(q_dev.cpu(), q_cpu) and torch.equal(
                s_dev.cpu().view(torch.int32), s_cpu.view(torch.int32))),
            "card = stored": (torch.equal(q_dev, stored_q) and torch.equal(
                s_dev.view(torch.int32), stored_s.view(torch.int32)))}
        off = int((s_dev != true_div).sum())
        rows = s_dev.numel()
        print(f"[kv_int8] (b) quantize_kv of the bf16 prefill's {name} "
              f"{list(x.shape)} ({rows} rows of {x.shape[-1]}): int8 values "
              f"and scales bit for bit, card against CPU {checks['card = CPU']}"
              f", card against the int8 prefill's stored leaves "
              f"{checks['card = stored']}; scales off the true division by "
              f"127 in {off} rows (the reference's jitted fp32(1/127) "
              f"product)")
        if not all(checks.values()):
            fail(f"the cache quantizer of {name} differs between the card, "
                 f"the CPU and the int8 prefill")
    del leaves, x, q_dev, s_dev, q_cpu, s_cpu, true_div, stored_q, stored_s
    torch.cuda.empty_cache()

    # ---- (c) the engine, dense and paged, with 3e's prefix
    reqs, prefix, carriers = engine_traffic(cfg.vocab_size)
    reqs = reqs[:KV8_REQUESTS]
    carriers = {j for j in carriers if j < KV8_REQUESTS}
    kinds = {"dense": {},
             "paged": {"kv_pages": ENGINE_PAGES, "page_tokens": 128}}
    engines, runs = {}, {}
    reset_counts(mods)
    for key, kw in kinds.items():
        engine = serving.ContinuousBatchingEngine(
            cfg8, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
            clock=time.monotonic, device=dev, **kw)
        run = drive_engine(engine, reqs, prefix, carriers, mods,
                           time.monotonic)
        engine.drop_prefix(run["pid"])
        engines[key], runs[key] = engine, run
        print(f"[kv_int8] (c) engine {key}, {len(reqs)} requests of phase "
              f"3e with its {ENGINE_PREFIX}-token prefix on {len(carriers)}: "
              f"{run['emitted']} tokens, fresh prefills {run['fresh']}, "
              f"flash_fwd launches {run['launched']['flash_fwd']}; pages in "
              f"use after {engine.pages_in_use}, null page zero "
              f"{engine.null_page_is_zero()}")
        if engine.pages_in_use or not engine.null_page_is_zero():
            fail(f"the int8 {key} pool did not drain, or page 0 is not zero")
    engine_launches = read_counts(mods)
    dense, paged = engines["dense"], engines["paged"]
    same = all(np.array_equal(runs["dense"]["tokens"][j],
                              runs["paged"]["tokens"][j]) for j in range(
                                  len(reqs)))
    print(f"[kv_int8] (c) paged tokens equal dense, token for token: {same}")
    if not same:
        fail("the int8 paged engine's tokens differ from the dense one's")
    # the control, off the counted path: each decode step's K/V (and
    # scales) written one position late
    append = transformer._append_per_row

    def late(k, v, positions, cache):
        append(k, v, positions + 1, cache)

    control = serving.ContinuousBatchingEngine(
        cfg8, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
        clock=time.monotonic, device=dev)
    with mock.patch.object(transformer, "_append_per_row", late):
        runs["control"] = drive_engine(control, reqs, prefix, carriers,
                                       mods, time.monotonic)
    del control
    # the teacher: the int8-cache model fed as the engine feeds its cache
    model = decode.decode_model(
        dataclasses.replace(cfg8, max_seq_len=ENGINE_MAX_LEN), params, dev)
    tau = TAU_MULT * diff
    for key in ("dense", "control"):
        tau_gate(f"[kv_int8] (c) {key}", teacher_forced_gaps(
            model, reqs, runs[key]["tokens"], prefix, carriers, plain_flash,
            transformer, decode, over_cache=True), tau, diff,
            control=key == "control", every=False)
    del model
    for key, engine in engines.items():
        shape = dict(batch=ENGINE_SLOTS, length=ENGINE_MAX_LEN)
        if key == "paged":
            shape = dict(batch=ENGINE_PAGES + 1, length=128)
        want8 = cache_nbytes(decode, cfg8, **shape)
        bf16 = cache_nbytes(decode, cfg, **shape)
        print(f"[kv_int8] (c) kv_bytes_per_chip {key}: "
              f"{engine.kv_bytes_per_chip:,} B against bf16's {bf16:,} B: "
              f"{engine.kv_bytes_per_chip / bf16:.4f}")
        if engine.kv_bytes_per_chip != want8:
            fail(f"the int8 {key} pool holds {engine.kv_bytes_per_chip} B, "
                 f"not {want8}")
    print(f"[time] {gpu}: engine llama2_7b bf16 weights, {ENGINE_SLOTS} "
          f"slots x {ENGINE_MAX_LEN}, decode step at occupancy "
          f"{ENGINE_SLOTS} (median, host clock): int8 cache dense "
          f"{median(runs['dense']['step_ms']):.2f} ms over "
          f"{len(runs['dense']['step_ms'])} steps, paged "
          f"{median(runs['paged']['step_ms']):.2f} ms over "
          f"{len(runs['paged']['step_ms'])}; bf16 cache dense (phase 3e (a)) "
          f"{median(plain_a['step_ms']):.2f} ms over "
          f"{len(plain_a['step_ms'])}")

    # ---- (d) one handoff at bucket 1024, dense (M, P) -> paged (D)
    prompt, n_new = reqs[KV8_HANDOFF_REQUEST]
    reset_counts(mods)
    rid = dense.submit(prompt, n_new)
    m_tokens = dense.run()[rid]
    timing = {}
    t0 = time.perf_counter()
    job = dense.start_prefill(prompt)
    while not job.advance():
        pass
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seal = serving.KVHandoff.seal

    def timed_seal(self):
        t = time.perf_counter()
        out = seal(self)
        timing["seal"] = (time.perf_counter() - t) * 1e3
        return out

    with mock.patch.object(serving.KVHandoff, "seal", timed_seal):
        h = job.handoff()
    timing["prefill"] = (t1 - t0) * 1e3
    timing["export"] = (time.perf_counter() - t1) * 1e3 - timing["seal"]
    t0 = time.perf_counter()
    ok = h.verify()
    timing["verify"] = (time.perf_counter() - t0) * 1e3
    byte = h.cache["k_scale"].view(torch.uint8).view(-1)
    byte[0] ^= 0xFF
    caught = not h.verify()
    byte[0] ^= 0xFF
    pb = decode._bucket_len(h.pos, ENGINE_MAX_LEN)
    adopt = paged._adopt_into_slot

    def timed_adopt(*args, **kw):
        t = time.perf_counter()
        adopt(*args, **kw)
        torch.cuda.synchronize()
        timing["adopt"] = (time.perf_counter() - t) * 1e3

    d_prefilled = paged.stats["prefill_positions"]
    with mock.patch.object(paged, "_adopt_into_slot", timed_adopt):
        d_rid = paged.submit_kv(h, n_new)
        d_tokens = paged.run()[d_rid]
    handoff_launches = read_counts(mods)
    d_prefilled = paged.stats["prefill_positions"] - d_prefilled
    print(f"[kv_int8] (d) handoff of request {KV8_HANDOFF_REQUEST} (prompt "
          f"{prompt.size}, bucket {pb}): leaves {list(h.cache)}, "
          f"{h.nbytes:,} B (bf16: {pb * HANDOFF_BYTES_PER_POSITION:,} B); "
          f"verify {ok}, a flipped k_scale byte caught {caught}; D's "
          f"{d_tokens.size} tokens equal M's batch-1 admission: "
          f"{np.array_equal(d_tokens, m_tokens)}; flash_fwd launches "
          f"{handoff_launches['flash_fwd']} (M's and P's prefills; D none), "
          f"D prefill positions {d_prefilled}")
    if (pb != 1024 or h.nbytes != KV8_HANDOFF_BYTES or not ok or not caught
            or list(h.cache) != ["k", "k_scale", "v", "v_scale"]
            or not np.array_equal(d_tokens, m_tokens)
            or handoff_launches["flash_fwd"] != 2 * cfg.n_layers
            or d_prefilled or paged.pages_in_use):
        fail("the int8 handoff at bucket 1024 is not sound")
    print(f"[time] {gpu}: int8 handoff at bucket 1024 ({h.nbytes:,} B): P "
          f"prefill {timing['prefill']:.2f} ms, export (device → host) "
          f"{timing['export']:.2f} ms, seal {timing['seal']:.2f} ms, verify "
          f"{timing['verify']:.2f} ms, submit_kv → adoption (host → "
          f"device, splice) {timing['adopt']:.2f} ms")
    del engines, dense, paged, h
    torch.cuda.empty_cache()

    # ---- times of (a), off the counted path
    prefill8 = wall_ms(lambda: decode.generate(cfg8, params, prompt4, 1), 3)
    gen8 = wall_ms(lambda: decode.generate(cfg8, params, prompt4, 64), 3)
    print(f"[time] {gpu}: generate llama2_7b bf16 batch 4 x prompt 512, int8 "
          f"cache: prefill (+1 token) {prefill8:.2f} ms, 64 tokens "
          f"{gen8:.2f} ms, per-token decode {(gen8 - prefill8) / 63:.3f} ms "
          f"(bf16 cache: {bf16_ms[0]:.2f}, {bf16_ms[1]:.2f}, "
          f"{bf16_ms[2]:.3f})")
    print(f"[time] phase 3h {time.perf_counter() - t_phase:.1f} s")
    return {name: launches[name] + engine_launches[name]
            + handoff_launches[name] for name in launches}


def served_gate(tag, reqs, served, prefix, carriers, models, plain_flash,
                transformer, decode, diff) -> None:
    """3e's teacher-forced gate on a serving-plane run: ``served`` maps
    request index -> (tokens, the version whose parameters served it), and
    each request is held against the no-cache forward of that version's
    model (``models``)."""
    per_req = []
    for version, model in models.items():
        js = sorted(j for j, (_, v) in served.items() if v == version)
        if js:
            per_req += teacher_forced_gaps(
                model, [reqs[j] for j in js],
                {i: served[j][0] for i, j in enumerate(js)}, prefix,
                {i for i, j in enumerate(js) if j in carriers}, plain_flash,
                transformer, decode)
    tau_gate(tag, per_req, TAU_MULT * diff, diff)


def flash_per_fresh_prefill(tag, engines: dict, launched: dict,
                            n_layers: int) -> None:
    """The path's flash_fwd launches must be one a layer per fresh prefill
    of its engines, and no other kernel may launch."""
    fresh = {name: e.stats["fresh_prefills"] for name, e in engines.items()}
    want = n_layers * sum(fresh.values())
    print(f"{tag} flash_fwd launches {launched['flash_fwd']} = {n_layers} x "
          f"fresh prefills " + ", ".join(
              f"{name} {n} ({n_layers * n} launches)"
              for name, n in fresh.items()))
    if (launched["flash_fwd"] != want or not want
            or any(c for name, c in launched.items() if name != "flash_fwd")):
        fail(f"{tag} launches {launched}, expected {want} flash_fwd")


def plane_gateway(cfg, params, traffic, mods, serving, plane, chaos_mod,
                  metrics_mod, dev, plain_a) -> tuple:
    """Phase 7 (a): ``ServingGateway`` over one engine, three tenants at
    weights 1:2:4 and a queue bound of PLANE_QUEUE_BOUND, under
    ``engine_crash_mid_decode(at_steps=(PLANE_CRASH_STEP,))``. All 24
    requests are submitted at once: the queue takes PLANE_QUEUE_BOUND and
    sheds the rest with a typed queue-full ``Rejected``; the shed ones are
    submitted again once the queue has drained. One request is cancelled
    mid-decode; one, submitted last into a free slot with a
    PLANE_DEADLINE_S deadline, expires mid-decode. Both must leave their
    slots on the step that finalizes them. Returns the served tokens and
    the launches."""
    reqs, prefix, carriers = traffic
    RS = plane.RequestState
    reset_counts(mods)
    engine = serving.ContinuousBatchingEngine(
        cfg, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
        clock=time.monotonic, device=dev)
    metrics = metrics_mod.ServingMetrics()
    gw = plane.ServingGateway(
        engine, plane.AdmissionConfig(max_queue_depth=PLANE_QUEUE_BOUND),
        tenant_weights=PLANE_TENANTS, metrics=metrics, clock=time.monotonic)
    pid = engine.register_prefix(prefix)
    engine_ms = [0.0]
    engine_step = engine.step

    def timed_step():
        t0 = time.perf_counter()
        try:
            return engine_step()
        finally:
            engine_ms[0] += (time.perf_counter() - t0) * 1e3

    engine.step = timed_step
    engine_abort = engine.abort
    aborts = []            # (free_slots before, after) of each abort a step

    def counted_abort(erid):
        before = engine.free_slots
        try:
            return engine_abort(erid)
        finally:
            aborts.append((before, engine.free_slots))

    engine.abort = counted_abort
    tenants = sorted(PLANE_TENANTS)
    streams, job, results = {}, {}, {}

    def submit(j, **kw):
        p, n = reqs[j]
        r = gw.submit(p, n, tenant=tenants[j % len(tenants)],
                      prefix_id=pid if j in carriers else None,
                      on_token=lambda rid, t: streams[rid].append(t), **kw)
        if not isinstance(r, plane.Rejected):
            streams[r], job[r] = [], j
        return r

    shed, reasons = [], Counter()
    for j in range(len(reqs)):
        r = submit(j)
        if isinstance(r, plane.Rejected):
            shed.append(j)
            reasons[r.reason] += 1
    print(f"[plane] (a) {len(reqs)} requests submitted at once: "
          f"{len(reqs) - len(shed)} queued, {len(shed)} shed {dict(reasons)}")
    if (len(shed) != len(reqs) - PLANE_QUEUE_BOUND
            or set(reasons) != {plane.admission.REASON_QUEUE_FULL}):
        fail(f"the gateway shed {dict(reasons)} of {len(reqs)} at a queue "
             f"bound of {PLANE_QUEUE_BOUND}")
    j_dead = max(shed, key=lambda j: reqs[j][1])
    j_cancel = max((job[r] for r in job), key=lambda j: reqs[j][1])
    r_cancel = next(r for r, j in job.items() if j == j_cancel)
    r_dead = resubmitted = None
    step_host, freed = [], {}
    inj = chaos_mod.engine_crash_mid_decode(
        at_steps=(PLANE_CRASH_STEP,)).injector()
    chaos_mod.install(inj)
    t0 = time.perf_counter()
    try:
        while (r_dead is None or resubmitted is None
               or gw.has_live_requests):
            if resubmitted is None and gw.queue_depth == 0:
                resubmitted = [submit(j) for j in shed if j != j_dead]
                if any(isinstance(r, plane.Rejected) for r in resubmitted):
                    fail(f"the gateway refused a resubmission: {resubmitted}")
            elif (r_dead is None and resubmitted is not None
                  and gw.queue_depth == 0 and engine.free_slots > 0):
                r_dead = submit(j_dead, deadline_s=PLANE_DEADLINE_S)
            if (gw.state(r_cancel) is RS.DECODING
                    and len(streams[r_cancel]) >= 4
                    and r_cancel not in freed):
                gw.cancel(r_cancel)
            engine_ms[0] = 0.0
            aborts.clear()
            t_step = time.perf_counter()
            done = gw.step()
            step_host.append((time.perf_counter() - t_step) * 1e3
                             - engine_ms[0])
            # a cancelled or expired request leaves its slot through
            # engine.abort on the step that finalizes it: that step holds
            # one abort that raised free_slots by one for each of them
            ending = [rid for rid in (r_cancel, r_dead)
                      if rid in done and rid not in freed]
            n_freed = sum(after == before + 1 for before, after in aborts)
            for rid in ending:
                freed[rid] = n_freed >= len(ending)
            for rid in done:
                results[rid] = gw.result(rid)
    finally:
        chaos_mod.uninstall()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = read_counts(mods)
    states = Counter(res.state.value for res in results.values())
    print(f"[plane] (a) outcomes {dict(states)}; injector {inj.events}; "
          f"engine crashes {engine.stats['crashes']}, replayed "
          f"{metrics.counters['requests_replayed']}; cancelled and expired "
          f"slots freed on their step {freed}")
    if set(results) != set(job):
        fail("the gateway lost a request silently")
    planned = {rid: (RS.CANCELLED if rid == r_cancel
                     else RS.DEADLINE_EXCEEDED if rid == r_dead
                     else RS.DONE) for rid in job}
    wrong = {rid: res.state.value for rid, res in results.items()
             if res.state is not planned[rid]}
    if wrong:
        fail(f"gateway requests ended off plan: {wrong}")
    for rid in (r_cancel, r_dead):
        n = results[rid].tokens.size
        if not 0 < n < reqs[job[rid]][1] or not freed.get(rid):
            fail(f"gateway request {rid} ({results[rid].state.value}) "
                 f"kept {n} tokens or its slot")
    if engine.stats["crashes"] != 1 or inj.fired_total() != 1:
        fail("the planted engine crash did not happen once")
    replayed = 0
    for rid, res in results.items():
        toks = res.tokens.tolist()
        stream = streams[rid]
        replayed += len(stream) > len(toks)
        if stream[len(stream) - len(toks):] != toks:
            fail(f"gateway request {rid}: streamed {stream} for {toks}")
    if replayed > metrics.counters["requests_replayed"]:
        fail(f"{replayed} streams re-emitted tokens, "
             f"{metrics.counters['requests_replayed']} requests replayed")
    flash_per_fresh_prefill("[plane] (a)", {"engine": engine}, launched,
                            cfg.n_layers)
    served = {job[rid]: (res.tokens, "v1") for rid, res in results.items()
              if res.state is RS.DONE}
    emitted = sum(res.tokens.size for res in results.values())
    qwait = metrics.histograms["queue_wait_seconds"]
    ttft = metrics.histograms["time_to_first_token_seconds"]
    print(f"[plane] (a) gateway host time a step (gateway.step less "
          f"engine.step, wall) median {median(step_host):.3f} ms over "
          f"{len(step_host)} steps; p50 queue wait "
          f"{median(qwait) * 1e3:.1f} ms; p50 TTFT {median(ttft) * 1e3:.1f} "
          f"ms; {emitted / wall:.1f} tokens/s ({emitted} tokens in "
          f"{wall:.2f} s); 3e (a), the bare engine: "
          f"{plain_a['emitted'] / plain_a['wall']:.1f} tokens/s, p50 TTFT "
          f"{median(plain_a['ttft_ms']):.1f} ms")
    del engine, gw
    gc.collect()            # the gateway and its engine hold each other
    torch.cuda.empty_cache()
    return served, launched


def plane_fleet(cfg, params, v2, traffic, mods, serving, plane, chaos_mod,
                metrics_mod, dev) -> tuple:
    """Phase 7 (b): ``ServingFleet`` of two replicas over phase 3's
    tensors, prefix_bucket PLANE_PREFIX_BUCKET, under
    ``replica_crash_mid_decode("replica-1")`` (installed once the replicas
    are ready, so that its third step is mid-decode). Two requests arrive a
    step, the carriers as prefix + prompt; once half are in, the fleet
    rolls to ``v2`` with ``FleetRolloutPolicy(max_surge=1)``. Returns the
    served tokens, each with the version of the replica that served it,
    and the launches."""
    reqs, prefix, carriers = traffic
    RS = plane.RequestState
    reset_counts(mods)
    engines, version_of = {}, {}

    def factory_for(tree, version):
        def make(name):
            version_of[name] = version
            engines[name] = serving.ContinuousBatchingEngine(
                cfg, tree, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                clock=time.monotonic, device=dev)
            return engines[name]
        return make

    fleet = plane.ServingFleet(
        factory_for(params, "v1"), 2,
        probe=plane.ProbeConfig(slow_start_steps=2),
        router=plane.Router(prefix_bucket_len=PLANE_PREFIX_BUCKET),
        metrics=metrics_mod.FleetMetrics())
    while not all(r.routable for r in fleet.replicas.values()):
        fleet.step()
    inj = chaos_mod.replica_crash_mid_decode("replica-1").injector()
    chaos_mod.install(inj)
    job, results, refused, served_by = {}, {}, {}, {}
    phases = [(fleet.rollout_phase.value, 0.0)]
    t0 = time.perf_counter()
    try:
        while (len(job) + len(refused) < len(reqs) or fleet.has_live_requests
               or fleet.rollout_phase not in (plane.RolloutPhase.IDLE,
                                              plane.RolloutPhase.COMPLETE)):
            for _ in range(2):
                j = len(job) + len(refused)
                if j < len(reqs):
                    p, n = reqs[j]
                    full = np.concatenate([prefix, p]) if j in carriers else p
                    r = fleet.submit(full, n)
                    if isinstance(r, plane.Rejected):
                        refused[j] = r.reason
                    else:
                        job[r] = j
            if (fleet.rollout_phase is plane.RolloutPhase.IDLE
                    and len(job) + len(refused) >= len(reqs) // 2
                    and not phases[1:]):
                fleet.start_rollout(factory_for(v2, "v2"), "v2",
                                    plane.FleetRolloutPolicy(max_surge=1))
            for rid in fleet.step():
                served_by[rid] = fleet.replica_of(rid)
                results[rid] = fleet.result(rid)
            if fleet.rollout_phase.value != phases[-1][0]:
                phases.append((fleet.rollout_phase.value,
                               time.perf_counter() - t0))
    finally:
        chaos_mod.uninstall()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = read_counts(mods)
    states = Counter(res.state.value for res in results.values())
    print(f"[plane] (b) outcomes {dict(states)}, typed refusals "
          f"{refused}; injector {inj.events}; fleet stats {fleet.stats}")
    if set(results) != set(job) or len(job) + len(refused) != len(reqs):
        fail("the fleet lost a request silently")
    if any(res.state is not RS.DONE for res in results.values()):
        fail(f"fleet requests ended off DONE: {dict(states)}")
    if fleet.stats["ejected"] != 1 or inj.fired_total() != 1:
        fail("the planted replica crash did not eject replica-1 once")
    if fleet.stats["prefix_hits"] < 1:
        fail(f"the fleet hit no prefix: {fleet.stats}")
    if (fleet.rollout_phase is not plane.RolloutPhase.COMPLETE
            or fleet.router.weights != {"v2": 1.0}):
        fail(f"the rollout did not complete: {fleet.rollout_phase} "
             f"{fleet.router.weights}")
    flash_per_fresh_prefill("[plane] (b)", engines, launched, cfg.n_layers)
    served = {job[rid]: (res.tokens, version_of[served_by[rid]])
              for rid, res in results.items()}
    emitted = sum(res.tokens.size for res in results.values())
    print(f"[plane] (b) {emitted / wall:.1f} tokens/s ({emitted} tokens in "
          f"{wall:.2f} s); rerouted {fleet.stats['rerouted']}; prefix hits "
          f"{fleet.stats['prefix_hits']} misses "
          f"{fleet.stats['prefix_misses']}; requests by version "
          f"{dict(Counter(v for _, v in served.values()))}; rollout phases "
          f"(s from the first request) " + ", ".join(
              f"{ph} {t:.2f}" for ph, t in phases))
    del fleet, engines
    gc.collect()
    torch.cuda.empty_cache()
    return served, launched


def plane_disagg(cfg, params, traffic, mods, serving, plane, chaos_mod,
                 metrics_mod, dev) -> tuple:
    """Phase 7 (c): ``DisaggFleet`` with one prefill replica (dense) and one
    paged decode replica over phase 3's tensors, 3e's prefix registered in
    its ``FleetPrefixStore`` (so the carriers hand off suffix-only), under
    ``disagg_handoff_chaos`` (the 2nd handoff lost, the 4th corrupted).
    Returns the served tokens and the launches."""
    reqs, prefix, carriers = traffic
    RS = plane.RequestState
    reset_counts(mods)
    engines = {}

    def factory(name):
        paged = ({"kv_pages": ENGINE_PAGES, "page_tokens": 128}
                 if name.startswith("decode") else {})
        engines[name] = serving.ContinuousBatchingEngine(
            cfg, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
            clock=time.monotonic, device=dev, **paged)
        return engines[name]

    fm = metrics_mod.FleetMetrics()
    fleet = plane.DisaggFleet(
        factory, 1, 1, store=plane.FleetPrefixStore(metrics=fm),
        replay=plane.ReplayPolicy(max_replays=3),
        auto_register_prefixes=False, metrics=fm)
    fleet.register_prefix(prefix)
    seal_ms, verify = [], []
    seal, check = serving.KVHandoff.seal, serving.KVHandoff.verify

    def timed_seal(handoff):
        t0 = time.perf_counter()
        out = seal(handoff)
        seal_ms.append(((time.perf_counter() - t0) * 1e3, handoff.nbytes))
        return out

    def timed_verify(handoff):
        t0 = time.perf_counter()
        ok = check(handoff)
        verify.append(((time.perf_counter() - t0) * 1e3, ok))
        return ok

    inj = chaos_mod.disagg_handoff_chaos().injector()
    job, results, submitted, first = {}, {}, {}, {}
    t0 = time.perf_counter()
    with mock.patch.object(serving.KVHandoff, "seal", timed_seal), \
            mock.patch.object(serving.KVHandoff, "verify", timed_verify):
        chaos_mod.install(inj)
        try:
            while len(job) < len(reqs) or fleet.has_live_requests:
                for _ in range(2):
                    j = len(job)
                    if j < len(reqs):
                        p, n = reqs[j]
                        full = (np.concatenate([prefix, p]) if j in carriers
                                else p)
                        r = fleet.submit(
                            full, n, on_token=lambda rid, t: first.setdefault(
                                rid, time.monotonic()))
                        if isinstance(r, plane.Rejected):
                            fail(f"the disaggregated fleet refused request "
                                 f"{j}: {r.reason}")
                        job[r], submitted[r] = j, time.monotonic()
                for rid in fleet.step():
                    results[rid] = fleet.result(rid)
        finally:
            chaos_mod.uninstall()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = read_counts(mods)
    st, store = fleet.stats, fleet.store.stats
    states = Counter(res.state.value for res in results.values())
    failed = sum(not ok for _, ok in verify)
    print(f"[plane] (c) outcomes {dict(states)}; injector {inj.events}; "
          f"handoffs enqueued {st['handoffs_enqueued']} adopted "
          f"{st['handoffs_adopted']} lost {st['handoffs_lost']} corrupt "
          f"{st['handoffs_corrupt']}, replayed {st['replayed']}, "
          f"verify failures {failed}; events: "
          + "; ".join(ln for ln in fleet.event_log
                      if ln.startswith(("handoff_", "replay"))))
    if set(results) != set(job) or any(res.state is not RS.DONE
                                       for res in results.values()):
        fail(f"the disaggregated fleet lost or failed a request: "
             f"{dict(states)}")
    if (st["handoffs_lost"], st["handoffs_corrupt"], st["replayed"],
            st["retry_exhausted"], failed) != (1, 1, 2, 0, 1):
        fail(f"the handoff chaos was not caught and replayed: {st}")
    decode, prefill = engines["decode-0"], engines["prefill-0"]
    if decode.stats["fresh_prefills"] or decode.stats["prefill_positions"]:
        fail(f"the decode replica prefilled: {decode.stats}")
    flash_per_fresh_prefill("[plane] (c)", {"prefill-0": prefill,
                                            "decode-0": decode},
                            launched, cfg.n_layers)
    served = {job[rid]: (res.tokens, "v1") for rid, res in results.items()}
    emitted = sum(res.tokens.size for res in results.values())
    ttft = [(first[rid] - submitted[rid]) * 1e3 for rid in results]
    print(f"[plane] (c) handoff bytes median "
          f"{median(b for _, b in seal_ms):.0f} (max "
          f"{max(b for _, b in seal_ms)}), seal median "
          f"{median(ms for ms, _ in seal_ms):.1f} ms, verify median "
          f"{median(ms for ms, _ in verify):.1f} ms over {len(seal_ms)} "
          f"handoffs; p50 TTFT {median(ttft):.1f} ms; {emitted / wall:.1f} "
          f"tokens/s ({emitted} tokens in {wall:.2f} s); store hits "
          f"{store['hits']} promotes {store['promotes']} misses "
          f"{store['misses']}, overflow bytes {store['overflow_bytes']}")
    del fleet, engines, decode, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return served, launched


def plane_modelpool(cfg, params, v2, traffic, mods, serving, plane,
                    chaos_mod, metrics_mod, ledger_mod, dev) -> tuple:
    """Phase 7 (d): ``ModelPool`` over one engine with two models, phase 3's
    tree (v1) and ``v2``; the requests alternate between their lanes (the
    carriers as prefix + prompt), PLANE_SWAP_BATCH admissions a turn,
    under ``model_swap_failure(at_swap=2)``. Returns the served tokens,
    each with its model, and the launches."""
    reqs, prefix, carriers = traffic
    reset_counts(mods)
    engine = serving.ContinuousBatchingEngine(
        cfg, params, n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
        clock=time.monotonic, device=dev)
    swap_ms = []
    replace = engine.replace_params

    def timed_replace(tree, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = replace(tree, **kw)
        torch.cuda.synchronize()
        swap_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.replace_params = timed_replace
    ledger = ledger_mod.DecisionLedger(time.monotonic)
    metrics = metrics_mod.ModelPoolMetrics()
    pool = plane.ModelPool(engine, {"v1": params, "v2": v2}, active="v1",
                           swap_batch=PLANE_SWAP_BATCH, metrics=metrics,
                           ledger=ledger)
    job = {}
    for j, (p, n) in enumerate(reqs):
        full = np.concatenate([prefix, p]) if j in carriers else p
        job[pool.submit(("v1", "v2")[j % 2], full, n)] = j
    inj = chaos_mod.model_swap_failure(at_swap=2).injector()
    t0 = time.perf_counter()
    with inj:
        out = pool.run()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = read_counts(mods)
    print(f"[plane] (d) pool stats {pool.stats}; injector {inj.events}; "
          f"engine param swaps {engine.stats['param_swaps']}; decision log: "
          + "; ".join(pool.decision_log))
    for line in ledger.lines():
        print(f"[plane] (d) ledger: {line}")
    if set(out) != set(job) or any(out[rid].shape != (reqs[j][1],)
                                   for rid, j in job.items()):
        fail("the model pool lost or cut a request")
    if (pool.stats["swap_failures"], pool.stats["swap_retries"]) != (1, 1) \
            or engine.stats["param_swaps"] != pool.stats["swaps"]:
        fail(f"the refused swap was not retried once: {pool.stats}")
    flash_per_fresh_prefill("[plane] (d)", {"engine": engine}, launched,
                            cfg.n_layers)
    served = {job[rid]: (toks, ("v1", "v2")[job[rid] % 2])
              for rid, toks in out.items()}
    emitted = sum(t.size for t in out.values())
    print(f"[plane] (d) swaps {pool.stats['swaps']}, swap failures "
          f"{pool.stats['swap_failures']}; replace_params median "
          f"{median(swap_ms):.2f} ms a swap over {len(swap_ms)} "
          f"({', '.join(f'{ms:.2f}' for ms in swap_ms)}); "
          f"{emitted / wall:.1f} tokens/s ({emitted} tokens in "
          f"{wall:.2f} s)")
    del pool, engine
    gc.collect()
    torch.cuda.empty_cache()
    return served, launched


def serve_plane(cfg, params, mods, plain_flash, diff, plain_a, serving,
                transformer, decode, chaos_mod, metrics_mod, dev) -> dict:
    """Phase 7: the serving plane (``tpu_on_k8s_torch/serve/``) over
    engines on phase 3's weights with 3e's traffic: (a) the gateway, (b)
    the fleet with a rollout to a second tree ``v2`` (torch.Generator seed
    1), (c) the disaggregated fleet, (d) the model pool over v1 and v2
    ((c) and (d) on its first PLANE_CUT requests), each under its chaos
    scenario. Every DONE request's tokens must pass
    3e's teacher-forced gate against the model that served it. Returns
    each path's launches."""
    from tpu_on_k8s_torch import serve as plane
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.obs import ledger as ledger_mod

    t_phase = time.perf_counter()
    traffic = engine_traffic(cfg.vocab_size)
    reqs, prefix, carriers = traffic
    v2 = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    bcfg = dataclasses.replace(cfg, max_seq_len=ENGINE_MAX_LEN)
    models = {"v1": decode.decode_model(bcfg, params, dev),
              "v2": decode.decode_model(bcfg, v2, dev)}
    paths, served = {}, {}
    served["gateway"], paths["gateway"] = plane_gateway(
        cfg, params, traffic, mods, serving, plane, chaos_mod, metrics_mod,
        dev, plain_a)
    cut = {path: (reqs[:n], prefix, {j for j in carriers if j < n})
           for path, n in PLANE_CUT.items()}
    served["fleet"], paths["fleet"] = plane_fleet(
        cfg, params, v2, cut["fleet"], mods, serving, plane, chaos_mod,
        metrics_mod, dev)
    served["disagg_fleet"], paths["disagg_fleet"] = plane_disagg(
        cfg, params, cut["disagg_fleet"], mods, serving, plane, chaos_mod,
        metrics_mod, dev)
    served["modelpool"], paths["modelpool"] = plane_modelpool(
        cfg, params, v2, cut["modelpool"], mods, serving, plane, chaos_mod,
        metrics_mod, ledger_mod, dev)
    for tag, path in (("(a)", "gateway"), ("(b)", "fleet"),
                      ("(c)", "disagg_fleet"), ("(d)", "modelpool")):
        served_gate(f"[plane] {tag}", reqs, served[path], prefix, carriers,
                    models, plain_flash, transformer, decode, diff)
    del models, v2
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] phase 7 {time.perf_counter() - t_phase:.1f} s")
    return paths


def backward_products(model, loss_fn, tokens) -> int:
    """The ``aten.mm`` calls in one backward pass of ``model``."""
    loss, _ = loss_fn(tokens)
    counter = _CountProducts()
    with counter:
        torch.autograd.grad(loss, list(model.parameters()))
    return counter.mm


def quant_issue_figure(lib, r: int, c: int, clock_mhz: float) -> dict:
    """The quantizer's issue figure at [r, c] bf16: the SASS instructions of
    ``quant_kernel<bf16, kSteps>`` on its common path, per element a thread
    handles (kSteps vectors of 8), times the elements, over the card's issue
    rate (132 SMs x 4 schedulers x 32 lanes x the SM clock). The common path
    is the function less the regions a forward branch skips that hold the
    division's outright fallback or a call (``FCHK`` or ``CALL``, no
    ``FRND``), and less the called subroutines."""
    from tpu_on_k8s_torch.ops import _build

    steps = -(-c // 8 // 256)
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    body, fn = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn is not None and f"quant_kernelI13__nv_bfloat16Li{steps}E" in fn:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                body.append((int(m.group(1), 16), m.group(2)))
    if not body:
        fail(f"quant_kernel<bf16, {steps}> not found in the SASS")
    calls = [int(t, 16) for _, text in body
             for t in re.findall(r"CALL\.\S+\s+(0x[0-9a-f]+)", text)]
    end = min(calls, default=body[-1][0] + 1)
    cold = {a for a, _ in body if a >= end}
    for a, text in body:
        m = re.match(r"@!?P\d\s+BRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) > a:
            skipped = [(x, t) for x, t in body if a < x < int(m.group(1), 16)]
            if (any("FCHK" in t or "CALL" in t for _, t in skipped)
                    and not any("FRND" in t for _, t in skipped)):
                cold.update(x for x, _ in skipped)
    hot = len(body) - len(cold)
    per_elem = hot / (steps * 8)
    ms = per_elem * r * c / (132 * 4 * 32 * clock_mhz * 1e6) * 1e3
    return {"steps": steps, "hot": hot, "all": len(body),
            "per_elem": per_elem, "ms": ms}


def fuse_gateup(params: dict, n_layers: int) -> dict:
    """The same weights in the ``mlp_fused_gateup`` layout (gate first)."""
    out = dict(params)
    for i in range(n_layers):
        p = f"blocks.{i}.mlp."
        out[p + "w_gateup.weight"] = torch.cat(
            [out.pop(p + "w_gate.weight"), out.pop(p + "w_up.weight")])
    return out


def fuse_qkv(params: dict, n_layers: int) -> dict:
    """The same weights in the ``fused_qkv`` layout (q, then k, then v
    rows)."""
    out = dict(params)
    for i in range(n_layers):
        p = f"blocks.{i}.attn."
        out[p + "wqkv.weight"] = torch.cat(
            [out.pop(p + f"w{x}.weight") for x in "qkv"])
    return out


def sync_warnings(caught) -> list:
    """(file, line) of each synchronizing-call warning that
    ``torch.cuda.set_sync_debug_mode("warn")`` raised, in order."""
    return [(Path(w.filename).name, w.lineno) for w in caught
            if "synchroniz" in str(w.message)]


def by_site(syncs: list) -> dict:
    """Synchronizing calls counted by "file:line"."""
    out = {}
    for f, n in syncs:
        out[f"{f}:{n}"] = out.get(f"{f}:{n}", 0) + 1
    return out


def source_lines(fn) -> tuple:
    """(file name, the line numbers of ``fn``'s source)."""
    import inspect
    lines, start = inspect.getsourcelines(fn)
    return Path(inspect.getsourcefile(fn)).name, set(
        range(start, start + len(lines)))


def allowed_syncs(syncs: list, allowed: list) -> list:
    """The syncs that fall outside every (file, lines) of ``allowed``."""
    return [(f, n) for f, n in syncs
            if not any(f == af and n in lines for af, lines in allowed)]


def checkpoint_cli_roundtrip(mods, dev, tmp: Path) -> None:
    """Phase 3d, the checkpoint flags: ``train_llama --config tiny
    --checkpoint-dir D --eval-data F`` on ``cuda``, then ``generate
    --checkpoint-dir D`` and ``serve --checkpoint-dir D``, whose greedy
    tokens must equal those of the same parameters held in memory."""
    import contextlib
    import io

    from tpu_on_k8s_torch import generate as generate_cli
    from tpu_on_k8s_torch import serve as serve_cli
    from tpu_on_k8s_torch import train_llama
    from tpu_on_k8s_torch.data import write_records
    from tpu_on_k8s_torch.models import decode
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    from tpu_on_k8s_torch.train import train_state_template
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager

    cfg = TransformerConfig.tiny()
    ckpt, evalf = tmp / "ckpt", tmp / "eval.bin"
    write_records(str(evalf), np.random.default_rng(5).integers(
        0, cfg.vocab_size, (16, cfg.max_seq_len + 1)).astype(np.int32))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loss = train_llama.main(["--steps", "12", "--eval-every", "6",
                                 "--checkpoint-dir", str(ckpt),
                                 "--eval-data", str(evalf)])
    evals = [l for l in out.getvalue().splitlines() if l.startswith("[eval]")]
    state, gen, step = CheckpointManager(str(ckpt)).restore(
        train_state_template(cfg, dev, warmup_steps=10, decay_steps=12))
    held = {n: p.detach().to(torch.float32 if n.endswith("scale")
                             else cfg.dtype)
            for n, p in state.model.named_parameters()}
    with contextlib.redirect_stdout(io.StringIO()):
        tokens = generate_cli.main(["--checkpoint-dir", str(ckpt)])
        served = serve_cli.main(["--checkpoint-dir", str(ckpt)])
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.
                           Generator(device=dev).manual_seed(0), device=dev,
                           dtype=torch.int32)
    want = decode.generate(cfg, held, prompt, 32, device=dev)
    # serve's traffic with its defaults: the same seeded arrivals
    rng = np.random.default_rng(0)
    eng = ContinuousBatchingEngine(cfg, held, n_slots=8, device=dev)
    done, n = {}, 0
    while n < 16:
        for _ in range(rng.poisson(1.0)):
            if n < 16:
                lp = int(rng.integers(4, 25))
                eng.submit(rng.integers(0, cfg.vocab_size,
                                        size=lp).astype(np.int32), 16)
                n += 1
        for rid in eng.step():
            done[rid] = eng.result(rid)
    done.update(eng.run())
    same_serve = (set(done) == set(served) and all(
        np.array_equal(np.asarray(served[r]), np.asarray(done[r]))
        for r in done))
    print(f"[cli] train_llama --config tiny --checkpoint-dir --eval-data "
          f"--eval-every 6 (cuda, 12 steps): final loss {loss:.5f}; "
          f"{evals}; restored generation {gen} step {step} (count "
          f"{state.optimizer.count}); generate --checkpoint-dir tokens equal "
          f"to the held parameters' generate: {torch.equal(tokens, want)}; "
          f"serve --checkpoint-dir, {len(served)} requests equal to the held "
          f"parameters' engine: {same_serve}")
    if (not math.isfinite(loss) or len(evals) != 2 or (gen, step) != (0, 12)
            or state.optimizer.count != 12):
        fail("train_llama --checkpoint-dir/--eval-data did not save step 12 "
             "and evaluate at steps 6 and 12")
    if not torch.equal(tokens, want) or not same_serve:
        fail("a CLI restored from the checkpoint decoded other tokens than "
             "the same parameters held in memory")


def train_loop_phase(tcfg, mods, gpu, dev, train_ms, tmp: Path,
                     p4: dict) -> dict:
    """Phase 4c: ``Trainer.fit`` at llama2_1b (remat mlp, flash), 12
    distinct seeded batches through ``device_prefetch``; a fault-free run,
    a run preempted before step 7 (``train_preemption(7)``) saving at steps
    4 and 6, and a resume from the checkpoint, whose stitched losses must
    equal the fault-free run's bit for bit. Returns the launches of the
    three runs; the step's FLOP count goes into ``p4["flops"]``."""
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.data.prefetch import device_prefetch
    from tpu_on_k8s_torch.metrics import TrainMetrics
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import checkpoint as ckpt_mod
    from tpu_on_k8s_torch.train import loop as loop_mod
    from tpu_on_k8s_torch.train import train_state_template
    from tpu_on_k8s_torch.train.compile import (
        analytic_train_flops,
        train_step_flops,
    )

    class Recording(Trainer):
        """The two-argument ``train_step`` (the one ``fit`` drives) also
        keeps each step's loss, a 0-d device tensor: no sync."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.losses = []

        def train_step(self, *args):
            out = super().train_step(*args)
            if len(args) == 2:
                self.losses.append(out[1]["loss"])
            return out

    steps, every, preempt_at, log_every = LOOP_STEPS, 4, 7, 4
    opt_kw = dict(warmup_steps=10, decay_steps=max(steps, 11))
    p0 = init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=tcfg.param_dtype)
    batches = np.random.default_rng(LOOP_SEED).integers(
        0, tcfg.vocab_size, (steps, TRAIN_BATCH, TRAIN_SEQ + 1)).astype(
            np.int32)

    def fresh():
        model = load_model(tcfg, {k: v.clone() for k, v in p0.items()}, dev)
        return Recording(model, default_optimizer(model.parameters(),
                                                **opt_kw))

    host_sync = source_lines(loop_mod._host_sync)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ

    # the exact FLOP count of a step, on the card, beside 6·N·T
    trainer = fresh()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    flops, _ = train_step_flops(trainer, trainer.state(),
                                torch.from_numpy(batches[0]).to(dev))
    analytic = analytic_train_flops(n_params, tokens_per_step)
    p4["flops"] = flops
    print(f"[train-loop] {gpu}: train_step_flops (FlopCounterMode, the flash "
          f"and int8 kernels as operators with their formulas) {flops:.6e} "
          f"FLOPs a step, 6·N·T {analytic:.6e} (N {n_params:,}, T "
          f"{tokens_per_step}): ratio {flops / analytic:.4f} (gate "
          f"0.3-1.7)")
    if not 0.3 < flops / analytic < 1.7:
        fail(f"train_step_flops {flops:.4e} is not within 0.3-1.7 of 6NT "
             f"{analytic:.4e}")

    def run(trainer, state, first, n, **kw):
        windows = []
        metrics = TrainMetrics()
        torch.cuda.synchronize()
        reset_counts(mods)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = trainer.fit(
                    state, device_prefetch(iter(batches[first:first + n]),
                                           dev), n,
                    log_every=log_every, metrics=metrics,
                    tokens_per_step=tokens_per_step, flops_per_step=flops,
                    peak_flops=PEAK_BF16_FLOPS,
                    on_metrics=lambda s, m, dt: windows.append(dt), **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return result, windows, metrics, read_counts(mods), sync_warnings(
            caught)

    # (a) the fault-free run
    torch.cuda.reset_peak_memory_stats()
    ref, ref_windows, ref_metrics, ref_counts, ref_syncs = run(
        trainer, trainer.state(), 0, steps)
    ref_losses = torch.stack(trainer.losses).cpu()
    ref_final = {n: p.detach().clone()
                 for n, p in trainer.model.named_parameters()}
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    stray = allowed_syncs(ref_syncs, [host_sync])
    loop_ms = statistics.median(ref_windows[1:]) * 1e3
    print(f"[train-loop] fault-free Trainer.fit, {steps} steps, log_every "
          f"{log_every}: host_syncs {ref.host_syncs}, windows at "
          f"{[s for s, _ in ref.history]}, losses "
          f"{[round(x, 5) for x in ref_losses.tolist()]}; launches "
          f"{ref_counts}; synchronizing calls under set_sync_debug_mode: "
          f"{len(ref_syncs)} {by_site(ref_syncs)}, outside _host_sync "
          f"{by_site(stray)}")
    print(f"[train-loop] {gpu}: loop step ms by window "
          f"{[round(x * 1e3, 2) for x in ref_windows]}; median of windows "
          f"2-{len(ref_windows)} {loop_ms:.2f} ms beside phase 4's bare "
          f"train_step median {train_ms:.2f} ms ({loop_ms / train_ms:.4f}x); "
          f"mfu gauge {ref_metrics.gauges['mfu']:.4f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense; "
          f"tokens_per_sec gauge {ref_metrics.gauges['tokens_per_sec']:,.0f}"
          f"; peak memory {ref_peak:.2f} GB")
    want = {k: steps * tcfg.n_layers
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if ref.host_syncs != 3 or len(ref_syncs) != 3 or stray:
        fail(f"the fault-free loop synced {ref_syncs} ({ref.host_syncs} "
             f"windows): expected the 3 window syncs and nothing else")
    if any(ref_counts[k] != v for k, v in want.items()):
        fail(f"loop launches {ref_counts}; expected {want}")
    del trainer
    torch.cuda.empty_cache()

    # (b) the preempted run: saves at step 4 (async) and 6 (preemption)
    trainer = fresh()
    ckdir = tmp / "loop_ckpt"
    mgr = ckpt_mod.CheckpointManager(str(ckdir), max_to_keep=1)
    with chaos.train_preemption(preempt_at).injector():
        first, _, _, first_counts, first_syncs = run(
            trainer, trainer.state(), 0, steps, checkpoint_manager=mgr,
            checkpoint_every=every)
    first_losses = torch.stack(trainer.losses).cpu()
    stray = allowed_syncs(first_syncs, [host_sync])
    nbytes = sum(t.numel() * t.element_size()
                 for t in trainer.state().state_dict().values())
    print(f"[train-loop] preempted run under train_preemption({preempt_at}), "
          f"checkpoint_every {every}, max_to_keep 1: preempted "
          f"{first.preempted}, steps {first.steps}, saves enqueued "
          f"{first.checkpoints_enqueued}, failures "
          f"{first.checkpoint_failures}, kept {mgr.steps(0)}; launches "
          f"{first_counts}; synchronizing calls {len(first_syncs)} "
          f"{by_site(first_syncs)}, outside _host_sync {by_site(stray)}")
    if (not first.preempted or first.steps != preempt_at - 1
            or first.checkpoints_enqueued != 2 or first.checkpoint_failures
            or mgr.steps(0) != [preempt_at - 1] or stray):
        fail("the preempted loop did not stop at step 6 with steps 4 and 6 "
             "saved (or synced outside its windows)")
    # the manager stays open: the snapshot buffers its two saves allocated
    # serve the timed saves below, which need no save of their own to
    # allocate them
    del trainer
    torch.cuda.empty_cache()

    # (c) the resume into a third, fresh TrainState
    template = train_state_template(tcfg, dev, **opt_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, gen, step = mgr.restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    count = state.optimizer.count
    trainer = Recording(state.model, state.optimizer)
    resumed, _, _, resumed_counts, resumed_syncs = run(
        trainer, state, step, steps - step)
    stitched = torch.cat([first_losses, torch.stack(trainer.losses).cpu()])
    same_losses = torch.equal(stitched, ref_losses)
    same_params = all(torch.equal(p, ref_final[n])
                      for n, p in state.model.named_parameters())
    print(f"[train-loop] resumed from generation {gen} step {step} (count "
          f"{count}) into a fresh TrainState, steps "
          f"{step + 1}-{steps}: launches {resumed_counts}; stitched losses "
          f"equal to the fault-free run's bit for bit: {same_losses}; final "
          f"weights equal bit for bit: {same_params}")
    if (not same_losses or not same_params or step != preempt_at - 1
            or count != step):
        fail(f"the stitched run differs from the fault-free one: "
             f"{stitched.tolist()} vs {ref_losses.tolist()}")
    stray = allowed_syncs(resumed_syncs, [host_sync])
    if stray or resumed.host_syncs != 2:
        fail(f"the resumed loop synced outside its windows: "
             f"{by_site(stray)}")

    # the checkpoint's costs on this state, on (b)'s manager (its buffers
    # allocated): the snapshot's stall on the compute stream, the next step
    # beside a plain one, and the write, from the enqueue to its last byte
    # (one save: a second, blocking one was cut to make room for phase 17)
    tok = torch.from_numpy(batches[0]).to(dev)

    def timed_step() -> float:
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        trainer.train_step(state, tok)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    plain_step = min(timed_step() for _ in range(2))
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    t0 = time.perf_counter()
    e0.record()
    mgr.save(state, step=101, wait=False)
    e1.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    after_save = timed_step()
    e1.synchronize()
    stall_ms = e0.elapsed_time(e1)
    mgr.wait_until_finished()
    write_s = time.perf_counter() - t0
    mgr.close()
    shutil.rmtree(ckdir, ignore_errors=True)
    print(f"[train-loop] {gpu}: checkpoint of the llama2_1b TrainState "
          f"{nbytes:,} B (fp32 masters and both fp32 moments); on the "
          f"preempted run's manager (device and pinned buffers allocated "
          f"by its saves) an async save: "
          f"{enqueue_ms:.2f} ms on the host to enqueue, the snapshot's "
          f"stall on the compute stream {stall_ms:.2f} ms, the next step "
          f"{after_save:.2f} ms beside a step without a save "
          f"{plain_step:.2f} ms (+{after_save - plain_step:.2f}), written "
          f"{write_s:.2f} s after the enqueue "
          f"({nbytes / write_s / 1e9:.3f} GB/s); "
          f"restore into a fresh TrainState {restore_s:.2f} s "
          f"({nbytes / restore_s / 1e9:.3f} GB/s)")
    del trainer, state, template, ref_final, p0
    torch.cuda.empty_cache()
    return {k: ref_counts[k] + first_counts[k] + resumed_counts[k]
            for k in ref_counts}


def remat_phase(tcfg, mods, gpu, dev, tokens, trainer_mod) -> dict:
    """Phase 4d: one step at llama2_1b under each remat policy: the loss
    and the gradients equal the no-remat step's bit for bit, the flash
    forward launches 32 (full), 16 (mlp), 32 (dots) and 16 (dots_kernels)
    times, and the backward under dots runs as many dense products as
    without remat. Returns the launches."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    p0 = init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=tcfg.param_dtype)
    want_fwd = {"full": 2 * tcfg.n_layers, "mlp": tcfg.n_layers,
                "dots": 2 * tcfg.n_layers, "dots_kernels": tcfg.n_layers}
    base = None
    total = None
    for policy in ("none", "full", "mlp", "dots", "dots_kernels"):
        cfg = dataclasses.replace(tcfg, remat=policy != "none",
                                  remat_policy=("mlp" if policy == "none"
                                                else policy))
        model = load_model(cfg, {k: v.clone() for k, v in p0.items()}, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mods)
        loss, _ = loss_fn(tokens)
        counter = _CountProducts()
        with counter:
            grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        launched = read_counts(mods)
        grad_peak = torch.cuda.max_memory_allocated() / 1e9
        trainer = Trainer(model, default_optimizer(model.parameters(),
                                                   warmup_steps=10,
                                                   decay_steps=11))
        trainer.train_step(tokens)              # warm: the moments allocate
        torch.cuda.synchronize()
        step_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            trainer.train_step(tokens)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        if policy == "none":
            base = (loss.detach(), grads, counter.mm)
            print(f"[remat] {gpu}: llama2_1b no remat: one forward+backward "
                  f"peak {grad_peak:.2f} GB, backward aten.mm {counter.mm}; "
                  f"train_step {min(step_ms):.2f} ms, peak {step_peak:.2f} "
                  f"GB; launches {launched}")
        else:
            same = (torch.equal(loss.detach(), base[0])
                    and all(torch.equal(a, b)
                            for a, b in zip(grads, base[1])))
            print(f"[remat] {gpu}: llama2_1b remat {policy}: loss and "
                  f"{len(grads)} gradients equal to no remat's bit for bit: "
                  f"{same}; flash_fwd {launched['flash_fwd']} (expected "
                  f"{want_fwd[policy]}), dq {launched['flash_bwd_dq']}, dkv "
                  f"{launched['flash_bwd_dkv']}; backward aten.mm "
                  f"{counter.mm} (no remat {base[2]}); forward+backward peak "
                  f"{grad_peak:.2f} GB; train_step {min(step_ms):.2f} ms, "
                  f"peak {step_peak:.2f} GB")
            if not same:
                fail(f"remat {policy} changed the loss or the gradients")
            if launched["flash_fwd"] != want_fwd[policy] or (
                    launched["flash_bwd_dq"] != tcfg.n_layers):
                fail(f"remat {policy} launches {launched}")
            if policy in ("mlp", "dots", "dots_kernels") and (
                    counter.mm != base[2]):
                fail(f"remat {policy}'s backward re-runs dense products: "
                     f"{counter.mm} against {base[2]}")
            total = launched if total is None else {
                k: total[k] + launched[k] for k in total}
        del model, trainer, grads, loss
        torch.cuda.empty_cache()
    del base, p0
    torch.cuda.empty_cache()
    return total


def gpt2_traffic(vocab: int):
    """Phase 6 (c)'s requests [(prompt, max_new_tokens)], the prefix and
    the indices of the requests that carry it, from GPT2_SEED; carriers are
    drawn among the requests that fit the prefix beside them in the
    1024-position table."""
    rng = np.random.default_rng(GPT2_SEED)
    reqs = [(rng.integers(0, vocab, size=int(rng.integers(64, 897)))
             .astype(np.int32), int(rng.integers(16, 65)))
            for _ in range(GPT2_REQUESTS)]
    prefix = rng.integers(0, vocab, size=GPT2_PREFIX).astype(np.int32)
    fits = [j for j, (p, n) in enumerate(reqs)
            if GPT2_PREFIX + p.size + n <= GPT2_HF_CONFIG["n_positions"]]
    carriers = set(rng.choice(fits, GPT2_CARRIERS, replace=False).tolist())
    return reqs, prefix, carriers


def gpt2_small_tree(convert, init_params, dev):
    """Phase 6's gpt2_small tree, fp32, from torch seed 0 on ``dev``: Flax's
    initialisation with its zero biases drawn normal(0, 0.02) too (else
    they would leave the bias paths unchecked). Returns (config, tree)."""
    hcfg = convert.config_from_hf_gpt2(types.SimpleNamespace(
        **GPT2_HF_CONFIG))
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(hcfg, g, dev, dtype=torch.float32)
    for name in params:
        if name.endswith(".bias"):
            params[name].normal_(0.0, 0.02, generator=g)
    return hcfg, params


def gpt2_phase(mods, gpu, dev, tmp: Path, plain_flash, fa, transformer,
               decode, serving, convert, trainer_mod) -> dict:
    """Phase 6: the GPT-2 family at gpt2_small width (vocab 50257, d_model
    768, 12 layers of 12 heads of 64, d_ff 3072, 1024 learned positions).
    (a) a biased tree from seed 0 through ``to_hf_gpt2`` and back through
    ``config_from_hf_gpt2`` (a namespace config) and
    ``params_from_hf_gpt2``, bit for bit; (b) ``generate`` batch 4 x 512 ->
    64 greedy in bf16, 12 flash_fwd launches a fresh prefill, the prefill
    logits within LOGITS_NOISE_MULT of the bf16 noise floor; (c) the engine
    on 8 slots (``max_len`` pinned at 1024), 24 seeded requests with a
    128-token prefix, dense and paged (equal tokens; every flash call of
    the paged run held against the plain attention), every token within
    tau of a teacher-forced maximum and a planted fault caught in every
    request; (d) gpt2_small (bias-free) training with flash and remat
    full, batch 8 x 1024: the step-1 gradient gate, 24/12/12 flash
    launches a step (12/12/12 under remat mlp), 8 steps through
    ``Trainer.fit``; (e) ``train_gpt2`` at its defaults, 2 steps, saved
    and resumed as generation 1; (f) the three flash kernels timed at
    GPT-2's shapes. Returns {"paths": launches by path, "d64": timings,
    "diff": (b)'s max|kernel - plain| prefill logits, the unit of (c)'s
    tau}."""
    import contextlib
    import io
    import itertools

    from tpu_on_k8s_torch import train_gpt2
    from tpu_on_k8s_torch.models.params import (
        init_params,
        keeps_fp32,
        load_model,
    )
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train.compile import train_step_flops

    t_phase = time.perf_counter()
    paths = {}
    # ---- (a) HF export and restore at full width -----------------------
    hcfg, params = gpt2_small_tree(convert, init_params, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = convert.to_hf_gpt2(hcfg, params)
    t1 = time.perf_counter()
    back = convert.params_from_hf_gpt2(sd, hcfg, torch.float32, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = set(back) == set(params) and all(
        torch.equal(back[n], params[n]) for n in params)
    tied = sd["lm_head.weight"] is sd["transformer.wte.weight"]
    unique = {t.data_ptr(): t for t in sd.values()}
    nbytes = sum(t.numel() * t.element_size() for t in unique.values())
    n_params = sum(t.numel() for t in params.values())
    print(f"[gpt2] (a) gpt2_small, use_bias (config_from_hf_gpt2 on a "
          f"namespace of GPT2Config's defaults): {hcfg.n_layers} layers "
          f"d_model {hcfg.d_model} heads {hcfg.n_heads} (head dim "
          f"{hcfg.head_dim}) d_ff {hcfg.d_ff} vocab {hcfg.vocab_size} "
          f"positions {hcfg.max_seq_len}, {n_params:,} params fp32; "
          f"to_hf_gpt2: {len(sd)} entries, {len(unique)} tensors, "
          f"{nbytes:,} B on the host (lm_head.weight is wte: {tied}), "
          f"{(t1 - t0) * 1e3:.0f} ms; params_from_hf_gpt2 back to the card "
          f"{(t2 - t1) * 1e3:.0f} ms; {len(back)} tensors equal to the "
          f"original bit for bit: {same}")
    if not same or not tied:
        fail("the GPT-2 HF round trip changed the tree or untied the head")
    del sd, back

    # ---- (b) generate, bf16 -----------------------------------------------
    cfg = dataclasses.replace(hcfg, dtype=torch.bfloat16)
    bparams = {n: t if keeps_fp32(n) else t.to(torch.bfloat16)
               for n, t in params.items()}
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 512)).astype(np.int32)).to(dev)
    reset_counts(mods)
    greedy = decode.generate(cfg, bparams, prompt, 64)
    torch.cuda.synchronize()
    paths["gpt2_generate"] = read_counts(mods)
    launched = paths["gpt2_generate"]
    print(f"[gpt2] (b) generate, bf16, batch 4 x prompt 512 -> 64 greedy "
          f"(cache at the table's 1024 positions): launches {launched}; "
          f"row 0 {greedy[0, :12].tolist()} ...")
    if launched["flash_fwd"] != cfg.n_layers or any(
            c for k, c in launched.items() if k != "flash_fwd"):
        fail(f"GPT-2 generate launches {launched}; expected "
             f"{cfg.n_layers} flash_fwd for its one fresh prefill")
    if (tuple(greedy.shape) != (4, 64) or int(greedy.min()) < 0
            or int(greedy.max()) >= cfg.vocab_size):
        fail(f"GPT-2 greedy tokens {tuple(greedy.shape)} out of range")
    if not torch.equal(decode.generate(cfg, bparams, prompt, 64), greedy):
        fail("a repeated GPT-2 greedy run gave other tokens")

    def prefill(model_cfg, model_params):
        model = decode.decode_model(model_cfg, model_params, dev)
        with torch.inference_mode():
            return model(prompt, None, decode.init_cache(model, 4))

    logits_k = prefill(cfg, bparams)
    with mock.patch.object(transformer, "flash_attention", plain_flash):
        logits_p = prefill(cfg, bparams)
        logits_32 = prefill(dataclasses.replace(cfg, dtype=torch.float32),
                            params)
    torch.cuda.synchronize()
    diff = (logits_k - logits_p).abs().max().item()
    noise = (logits_p - logits_32).abs().max().item()
    k_noise = (logits_k - logits_32).abs().max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean()
    print(f"[gpt2] (b) prefill logits [4, 512, {cfg.vocab_size}]: "
          f"max|kernel bf16 - fp32 model| {k_noise:.3e} (tol "
          f"{LOGITS_NOISE_MULT:g} x bf16 noise {noise:.3e}); max|kernel - "
          f"plain| {diff:.3e}; max |logit| "
          f"{logits_p.abs().max().item():.3e}; argmax agreement "
          f"{agree.item():.4f}")
    if not bool(torch.isfinite(logits_k).all()) or (
            k_noise > LOGITS_NOISE_MULT * noise):
        fail("GPT-2 prefill logits with the kernel stray further from the "
             "fp32 model than bf16 rounding explains")
    del logits_k, logits_p, logits_32
    prefill_ms = wall_ms(lambda: decode.generate(cfg, bparams, prompt, 1))
    gen64_ms = wall_ms(lambda: decode.generate(cfg, bparams, prompt, 64),
                       GEN64_REPS)
    print(f"[time] {gpu}: generate gpt2_small bf16 batch 4 x prompt 512: "
          f"prefill (+1 token) {prefill_ms:.2f} ms, 64 tokens "
          f"{gen64_ms:.2f} ms, per-token decode "
          f"{(gen64_ms - prefill_ms) / 63:.3f} ms")

    # ---- (c) the engine -----------------------------------------------------
    reqs, prefix, carriers = gpt2_traffic(cfg.vocab_size)
    probe = serving.ContinuousBatchingEngine(cfg, bparams, n_slots=2,
                                             max_len=256, device=dev)
    pinned = probe.max_len
    try:
        serving.ContinuousBatchingEngine(cfg, bparams, n_slots=2,
                                         max_len=2048, device=dev)
        refused = False
    except ValueError:
        refused = True
    del probe
    print(f"[gpt2] (c) engine max_len 256 pinned to {pinned}; max_len 2048 "
          f"refused: {refused}")
    if pinned != cfg.max_seq_len or not refused:
        fail("a learned-position engine did not pin max_len to its table")
    kinds = {"a": ("dense", {}),
             "b": (f"paged, {GPT2_PAGES} pages of 128 tokens",
                   {"kv_pages": GPT2_PAGES, "page_tokens": 128}),
             "control": ("dense, each decode step reading its position's "
                         "table row one late (a planted fault)", {}),
             "kv_late": ("dense, each decode step's K/V written one "
                         "position late (phase 3e's planted fault)", {})}
    append = transformer._append_per_row

    def late(k, v, positions, cache):
        append(k, v, positions + 1, cache)

    worst, runs = {}, {}
    reset_counts(mods)
    for key, (label, kw) in kinds.items():
        if key == "control":
            paths["gpt2_engine"] = read_counts(mods)
        engine = serving.ContinuousBatchingEngine(
            cfg, bparams, n_slots=GPT2_SLOTS, clock=time.monotonic,
            device=dev, **kw)
        if key == "control":
            # the step model alone reads a table shifted by one row; the
            # prefill model keeps the true one
            step = engine._step_model
            step.pos_embed = torch.nn.Parameter(
                torch.roll(step.pos_embed, -1, 0), requires_grad=False)
        ctx = (flash_checked(transformer, plain_flash, worst) if key == "b"
               else mock.patch.object(transformer, "_append_per_row", late)
               if key == "kv_late" else nullcontext())
        with ctx:
            run = drive_engine(engine, reqs, prefix, carriers, mods,
                               time.monotonic)
        engine.drop_prefix(run["pid"])
        run["pages_in_use"] = engine.pages_in_use
        run["null_page_zero"] = engine.null_page_is_zero()
        runs[key] = run
        print(f"[gpt2] (c) ({key}) {label}, {GPT2_SLOTS} slots x "
              f"{engine.max_len}, a {GPT2_PREFIX}-token prefix carried by "
              f"{len(carriers)} requests: {len(run['tokens'])} requests, "
              f"{run['emitted']} tokens, steps {engine.stats['steps']}; "
              f"fresh prefills {run['fresh']}, flash_fwd launches "
              f"{run['launched']['flash_fwd']} = {cfg.n_layers} x "
              f"{run['fresh']}")
        del engine
        torch.cuda.empty_cache()
    tol_o = TOL[torch.bfloat16][0]
    print(f"[gpt2] (c) (b) flash_fwd against the plain attention on the "
          f"engine's own q, k, v, max|o - plain| by bucket x batch (tol "
          f"{tol_o:g}): " + ", ".join(
              f"{l} x {b}: {e:.3e}" for (l, b), e in sorted(worst.items())))
    if not worst or max(worst.values()) > tol_o:
        fail("the flash forward strays from the plain attention on the "
             "GPT-2 engine's inputs")
    a = runs["a"]["tokens"]
    same = all(np.array_equal(a[j], runs["b"]["tokens"][j]) for j in a)
    b = runs["b"]
    print(f"[gpt2] (c) (b) tokens equal to (a): {same}; pages in use after "
          f"the prefix is dropped {b['pages_in_use']}, null page zero "
          f"{b['null_page_zero']}")
    if not same or b["pages_in_use"] or not b["null_page_zero"]:
        fail("the paged GPT-2 engine's tokens differ from the dense one's, "
             "or its pool did not drain")
    model = decode.decode_model(cfg, bparams, dev)
    gaps = {key: teacher_forced_gaps(model, reqs, runs[key]["tokens"],
                                     prefix, carriers, plain_flash,
                                     transformer, decode)
            for key in ("a", "control", "kv_late")}
    del model
    sound = torch.cat(gaps["a"]).max().item()
    print(f"[gpt2] (c) calibration, in units of (b)'s max|kernel - plain| "
          f"{diff:.4f}: the sound engine's worst gap {sound:.4f} "
          f"({sound / diff:.3f}), exact share "
          f"{(torch.cat(gaps['a']) == 0).float().mean().item():.4f}; "
          + "; ".join(
              f"{key}'s least per-request worst gap "
              f"{min(g.max().item() for g in gaps[key]):.4f} "
              f"({min(g.max().item() for g in gaps[key]) / diff:.3f}), "
              f"exact share "
              f"{(torch.cat(gaps[key]) == 0).float().mean().item():.4f}"
              for key in ("control", "kv_late")))
    tau = GPT2_TAU_MULT * diff
    for key in ("a", "control", "kv_late"):
        tau_gate(f"[gpt2] (c) ({key})", gaps[key], tau, diff,
                 key != "a", every=key == "control", mult=GPT2_TAU_MULT,
                 exact_min=GPT2_EXACT_MIN, unit="phase 6 (b)'s")
    for key in "ab":
        run = runs[key]
        print(f"[time] {gpu}: engine gpt2_small bf16 ({key}) {kinds[key][0]}"
              f", {GPT2_SLOTS} slots x 1024: decode step at occupancy "
              f"{GPT2_SLOTS} median {median(run['step_ms']):.2f} ms over "
              f"{len(run['step_ms'])} steps; "
              f"{run['emitted'] / run['wall']:.1f} tokens/s aggregate "
              f"({run['emitted']} tokens in {run['wall']:.2f} s); p50 TTFT "
              f"{median(run['ttft_ms']):.1f} ms")
    del runs, gaps, bparams, params
    torch.cuda.empty_cache()

    # ---- (d) training: gpt2_small, flash, remat full --------------------
    tcfg = dataclasses.replace(transformer.TransformerConfig.gpt2_small(),
                               attn_impl="flash")
    tp = init_params(tcfg, torch.Generator(device=dev).manual_seed(1), dev,
                     dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (GPT2_TRAIN_BATCH, GPT2_TRAIN_SEQ + 1))
        .astype(np.int32)).to(dev)

    def plain_bhld(q, k, v, causal=True, valid_len=0, segments=None):
        return fa.flash_attention_plain(q, k, v, causal, valid_len,
                                        segments)[0]

    def sdpa_bhld(q, k, v, causal=True, valid_len=0, segments=None):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)

    def twins():
        """The kernels' plain twins in their place, inside the kernels'
        own autograd Function: the same arithmetic and bf16 roundings (P
        and dS rounded before their products), in plain PyTorch."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            fa, "flash_with_lse_fwd", fa.flash_attention_plain))
        stack.enter_context(mock.patch.object(fa, "flash_bwd_dq",
                                              fa.flash_bwd_dq_plain))
        stack.enter_context(mock.patch.object(fa, "flash_bwd_dkv",
                                              fa.flash_bwd_dkv_plain))
        return stack

    def first_grads(model_cfg, attention="kernel"):
        model = load_model(model_cfg, tp, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = {"kernel": nullcontext,
                 "twins": twins,
                 "plain": lambda: mock.patch.object(
                     transformer, "flash_attention_bhld", plain_bhld),
                 "sdpa": lambda: mock.patch.object(
                     transformer, "flash_attention_bhld", sdpa_bhld),
                 }[attention]()
        with patch:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), dict(zip(names, grads))

    reset_counts(mods)
    loss_k, grads_k = first_grads(tcfg)
    torch.cuda.synchronize()
    full_counts = read_counts(mods)
    loss_t, grads_t = first_grads(tcfg, "twins")
    loss_p, grads_p = first_grads(tcfg, "plain")
    _, grads_s = first_grads(tcfg, "sdpa")
    loss_32, grads_32 = first_grads(
        dataclasses.replace(tcfg, dtype=torch.float32), "plain")
    reset_counts(mods)
    first_grads(dataclasses.replace(tcfg, remat_policy="mlp"))
    torch.cuda.synchronize()
    mlp_counts = read_counts(mods)
    n = tcfg.n_layers
    print(f"[gpt2] (d) gpt2_small, attn flash (D 64), batch "
          f"{GPT2_TRAIN_BATCH} x {GPT2_TRAIN_SEQ}, one forward+backward: "
          f"launches under remat full {full_counts}; under remat mlp "
          f"{mlp_counts}")
    if [full_counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv")] != [2 * n, n, n] or [
            mlp_counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")] != [n, n, n]:
        fail(f"GPT-2 training launches: full {full_counts}, mlp "
             f"{mlp_counts}; expected {2 * n}/{n}/{n} and {n}/{n}/{n}")
    def dist(g):
        return {k: ((g[k].float() - grads_32[k]).norm()
                    / grads_32[k].norm()).item() for k in grads_32}

    dist_k, dist_t, dist_p = dist(grads_k), dist(grads_t), dist(grads_p)
    dist_s = dist(grads_s)
    ratios = {k: dist_k[k] / dist_t[k] for k in dist_k}
    worst = max(ratios, key=ratios.get)
    vs_plain = {k: dist_k[k] / dist_p[k] for k in dist_k}
    twins_plain = {k: dist_t[k] / dist_p[k] for k in dist_k}
    print(f"[gpt2] (d) gradient gate, step 1, {len(dist_k)} tensors, "
          f"||g - g_fp32|| / ||g_fp32||: kernel bf16 max "
          f"{max(dist_k.values()):.4e} (at {max(dist_k, key=dist_k.get)}), "
          f"median {statistics.median(dist_k.values()):.4e}; the twins' "
          f"bf16 model max {max(dist_t.values()):.4e}, median "
          f"{statistics.median(dist_t.values()):.4e}; per-tensor ratio "
          f"kernel/twins median {statistics.median(ratios.values()):.3f}, "
          f"max {ratios[worst]:.3f} at {worst} (limit {GRAD_NOISE_MULT:g}); "
          f"step-1 loss kernel {loss_k:.6f}, twins {loss_t:.6f}, plain "
          f"{loss_p:.6f}, fp32 {loss_32:.6f}")
    print(f"[gpt2] (d) reading, not a gate: against the plain attention "
          f"through autograd (fp32 dS, phase 4's floor), kernel/plain "
          f"median {statistics.median(vs_plain.values()):.3f}, max "
          f"{max(vs_plain.values()):.3f} at {max(vs_plain, key=vs_plain.get)}"
          f"; twins/plain max {max(twins_plain.values()):.3f}; SDPA/plain "
          f"max {max(dist_s[k] / dist_p[k] for k in dist_k):.3f}: "
          f"near-uniform "
          f"random attention, where dS rounded to bf16 (the flash "
          f"algorithm's, the reference's and SDPA's) costs more than at "
          f"llama2_1b")
    if not all(torch.isfinite(v).all() for v in grads_k.values()) or (
            ratios[worst] > GRAD_NOISE_MULT):
        fail("the GPT-2 kernel model's gradients stray further from the "
             "fp32 model's than the kernels' own bf16 arithmetic explains")
    del grads_k, grads_t, grads_p, grads_s, grads_32
    torch.cuda.empty_cache()

    model = load_model(tcfg, tp, dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10,
        decay_steps=max(GPT2_TRAIN_STEPS, 11)))
    state = trainer.state()
    flops, _ = train_step_flops(trainer, state, tokens)
    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    trainer.fit(state, itertools.repeat(tokens), GPT2_TRAIN_STEPS,
                log_every=1, on_metrics=lambda step, m, dt: history.append(
                    (m["loss"], dt)))
    torch.cuda.synchronize()
    paths["gpt2_train"] = read_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [l for l, _ in history]
    step_s = statistics.median(dt for _, dt in history[1:])
    tok_s = GPT2_TRAIN_BATCH * GPT2_TRAIN_SEQ / step_s
    want = {"flash_fwd": 2 * n * GPT2_TRAIN_STEPS,
            "flash_bwd_dq": n * GPT2_TRAIN_STEPS,
            "flash_bwd_dkv": n * GPT2_TRAIN_STEPS}
    print(f"[gpt2] (d) Trainer.fit, {GPT2_TRAIN_STEPS} steps on one batch: "
          f"loss {[round(x, 5) for x in losses]}; launches "
          f"{paths['gpt2_train']}")
    print(f"[time] {gpu}: train step gpt2_small batch {GPT2_TRAIN_BATCH} x "
          f"{GPT2_TRAIN_SEQ} (remat full, flash, bf16, fp32 masters): median "
          f"of steps 2-{GPT2_TRAIN_STEPS} {step_s * 1e3:.1f} ms, "
          f"{tok_s:,.0f} tokens/s, peak memory {peak_gb:.2f} GB; "
          f"train_step_flops {flops:.4e} a step, mfu "
          f"{flops / step_s / PEAK_BF16_FLOPS:.4f} (of {PEAK_BF16_FLOPS:.3g} "
          f"bf16 FLOP/s)")
    if any(paths["gpt2_train"][k] != v for k, v in want.items()):
        fail(f"GPT-2 Trainer.fit launches {paths['gpt2_train']}; expected "
             f"{want}")
    if len(losses) != GPT2_TRAIN_STEPS or not all(
            map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"GPT-2 training loss not finite or not falling: {losses}")
    del trainer, model, state, tp
    torch.cuda.empty_cache()

    # ---- (e) train_gpt2 at its defaults, saved and resumed ---------------
    ckpt = str(tmp / "gpt2_ckpt")
    outs = []
    reset_counts(mods)
    t0 = time.perf_counter()
    for extra in ([], ["--generation", "1"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            loss = train_gpt2.main(["--steps", "2", "--checkpoint-dir", ckpt,
                                    *extra])
        outs.append((loss, out.getvalue()))
    torch.cuda.synchronize()
    paths["gpt2_cli"] = read_counts(mods)
    second = outs[1][1]
    resumed = [l for l in second.splitlines() if l.startswith("resumed")]
    print(f"[gpt2] (e) python -m tpu_on_k8s_torch.train_gpt2 --steps 2 "
          f"--checkpoint-dir D (defaults: gpt2_small, batch 8 x 512, cuda): "
          f"loss {outs[0][0]:.5f}; again with --generation 1: {resumed}, "
          f"loss {outs[1][0]:.5f}, "
          f"'{second.strip().splitlines()[-1]}'; launches "
          f"{paths['gpt2_cli']}; {time.perf_counter() - t0:.1f} s")
    if (resumed != ["resumed generation=0 step=2"]
            or "saved generation=1 step=4" not in second
            or not all(math.isfinite(l) for l, _ in outs)
            or paths["gpt2_cli"]["flash_fwd"] != 2 * 2 * 2 * n):
        fail("train_gpt2 did not save, resume from generation 0 step 2 and "
             "save generation 1 step 4")

    # ---- (f) the flash kernels at D 64, GPT-2's shapes --------------------
    tg = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=tg, device=dev).to(
            torch.bfloat16)

    d64 = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, d = hcfg.n_heads, hcfg.head_dim
    bb, lp = 4, 512
    q, k, v = (randn(bb, h, lp, d) for _ in range(3))
    d64["flash_fwd"] = [dict(
        shape=f"B={bb} H={h} L={lp} D={d} bf16 causal (gpt2 prefill)",
        ms=time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True)),
        plain_ms=plain_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, True)),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)),
        **dict(zip(("bound_ms", "bound_by"),
                   flash_bound_ms(bb, h, h, lp, d, True))))]
    bt, lt = GPT2_TRAIN_BATCH, GPT2_TRAIN_SEQ
    q, k, v, do = (randn(bt, h, lt, d) for _ in range(4))
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    fn, stream = sdpa_backward(q, k, v, do, is_causal=True)
    sdpa_bwd = time_ms(fn, stream=stream)
    shape = f"B={bt} H={h} L={lt} D={d} bf16 causal (gpt2 training)"
    d64["flash_fwd"].append(dict(
        shape=shape, ms=time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True)),
        plain_ms=plain_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, True)),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)),
        **dict(zip(("bound_ms", "bound_by"),
                   flash_bound_ms(bt, h, h, lt, d, True)))))
    d64["flash_bwd_dq"] = [dict(
        shape=shape,
        ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
        plain_ms=plain_time_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, True)),
        library_ms=sdpa_bwd,
        **dict(zip(("bound_ms", "bound_by"),
                   dq_bound_ms(bt, h, h, lt, d, True))))]
    d64["flash_bwd_dkv"] = [dict(
        shape=shape,
        ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
        plain_ms=plain_time_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, do, lse, delta, True)),
        library_ms=sdpa_bwd,
        **dict(zip(("bound_ms", "bound_by"),
                   dkv_bound_ms(bt, h, h, lt, d, True))))]
    for name, rows in d64.items():
        for r in rows:
            print(f"[time] {gpu}: {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                  f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
                  f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of "
                  f"bound")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    print(f"[time] phase 6 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "d64": d64, "diff": diff}


def free_port() -> int:
    """A free TCP port on this machine's loopback, for the world's store."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def first_difference(got, want) -> str:
    """'' when both sequences are equal; else the first step that differs."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"step {i + 1}: {a!r} vs {b!r} (diff {a - b:.3e})"
    return "" if len(got) == len(want) else f"lengths {len(got)}, {len(want)}"


def mesh_phase(tcfg, i8cfg, mods, gpu, dev, tokens, p4: dict,
               tmp: Path) -> dict:
    """Phase 8: mesh-sharded training at llama2_1b on a world of one rank
    made by ``train/distributed.py``'s ``initialize`` over NCCL (torchrun's
    variables, a loopback port): (a) ``Trainer(model, rules=
    flagship_partition_rules(), mesh=create_mesh(MeshConfig()))``, FSDP2
    over the one card, 8 steps on phase 4's batch, loss and grad norm
    against phase 4's unsharded run (predicted bit for bit), 16 launches of
    each flash kernel a step; (c) its state saved through the collective
    DCP path and restored onto the unsharded layout, every tensor
    bit-equal, and the next step from it equal to the live mesh's; (d) a
    ``ReshardNotice`` through ``TrainLoop`` before step 5, from the
    flagship rules to model-only rules on the same mesh, the trajectory
    equal to (a)'s; (b) every int8 flag on the mesh, 113 ``int8_matmul``
    launches a step, against phase 4b; (f) ``train_step_flops`` on the mesh against phase 4c's count
    (``p4["flops"]``) and the ``mfu`` gauge of a ``TrainLoop`` on the mesh.
    Returns the launches of the counted paths."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import (
        flagship_partition_rules,
    )
    from tpu_on_k8s_torch.parallel.mesh import (
        MeshConfig,
        create_mesh,
        mesh_shape,
    )
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
    from tpu_on_k8s_torch.train import (
        Trainer,
        default_optimizer,
        train_state_template,
    )
    from tpu_on_k8s_torch.metrics import TrainMetrics
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    from tpu_on_k8s_torch.train.compile import train_step_flops
    from tpu_on_k8s_torch.train.distributed import initialize
    from tpu_on_k8s_torch.train.loop import TrainLoop

    paths = {}
    t_phase = time.perf_counter()
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    ctx = initialize(env, device=dev)
    rules = flagship_partition_rules()
    mesh = create_mesh(MeshConfig(), device=dev)
    print(f"[mesh] world {dist.get_world_size()} (rank {ctx.process_id}, "
          f"backend {dist.get_backend()}, coordinator "
          f"{ctx.coordinator_address}): mesh {mesh_shape(mesh)} on "
          f"{mesh.device_type}")
    if dist.get_backend() != "nccl":
        fail(f"the mesh's world runs on {dist.get_backend()}, not nccl")
    opt_kw = dict(warmup_steps=10, decay_steps=max(TRAIN_STEPS, 11))

    def p0():
        return init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                           dev, dtype=tcfg.param_dtype)

    def sharded(cfg, params, rule_list=rules):
        model = load_model(cfg, params, dev)
        return Trainer(model, default_optimizer(model.parameters(), **opt_kw),
                       rules=rule_list, mesh=mesh)

    def train(trainer, state, n):
        losses, norms, ms = [], [], []
        batch = trainer.shard_batch(tokens)
        for _ in range(n):
            t0 = time.perf_counter()
            _, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, norms, ms

    # ---- (a) FSDP2 over the one card, phase 4's model and batch ---------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = sharded(tcfg, p0())
    state = trainer.state()
    reset_counts(mods)
    losses, norms, step_ms = train(trainer, state, TRAIN_STEPS)
    paths["mesh"] = read_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mesh_ms = statistics.median(step_ms[1:])
    print(f"[mesh] (a) llama2_1b on the mesh (FSDP2 per block and root, "
          f"flagship rules), {TRAIN_STEPS} steps on phase 4's batch: loss "
          f"{[round(x, 5) for x in losses]}, grad_norm "
          f"{[round(x, 4) for x in norms]}; launches {paths['mesh']}")
    per_step = {k: paths["mesh"][k] / TRAIN_STEPS
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"[mesh] (a) flash launches a step {per_step['flash_fwd']:g} / "
          f"{per_step['flash_bwd_dq']:g} / {per_step['flash_bwd_dkv']:g}")
    if any(v != tcfg.n_layers for v in per_step.values()):
        fail(f"mesh training launches {paths['mesh']}; expected "
             f"{tcfg.n_layers} of each flash kernel a step")
    loss_diff = first_difference(losses, p4["losses"])
    norm_diff = first_difference(norms, p4["norms"])
    print(f"[mesh] (a) against phase 4's unsharded run: losses "
          f"{'bit for bit' if not loss_diff else 'differ at ' + loss_diff}; "
          f"grad norms "
          f"{'bit for bit' if not norm_diff else 'differ at ' + norm_diff}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"mesh training loss not finite or not falling: {losses}")
    if loss_diff or norm_diff:
        fail("the world-1 mesh trajectory differs from phase 4's")
    print(f"[mesh] (a) {gpu}: step wall ms {[round(x, 1) for x in step_ms]}; "
          f"median of steps 2-{TRAIN_STEPS} {mesh_ms:.1f} ms (phase 4 "
          f"{p4['ms']:.1f} ms); peak memory {peak_gb:.2f} GB (phase 4 "
          f"{p4['peak_gb']:.2f} GB)")

    # ---- (c) the collective DCP path: mesh -> unsharded ------------------
    mgr = CheckpointManager(str(tmp / "mesh_ckpt"), max_to_keep=1)
    saved = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
             for k, v in state.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in saved.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, step=TRAIN_STEPS, wait=False)
    stall_s = time.perf_counter() - t0
    mgr.wait_until_finished()
    write_s = time.perf_counter() - t0
    plain = train_state_template(tcfg, dev, **opt_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _, at = mgr.restore(plain)
    torch.cuda.synchronize()
    restore_plain_s = time.perf_counter() - t0
    same_plain = [k for k, v in plain.state_dict().items()
                  if torch.equal(v, saved[k])]
    # the next step from the restored unsharded state, against the live
    # mesh's: (a) holds the two layouts' trajectories equal bit for bit
    back_trainer = Trainer(plain.model, plain.optimizer)
    next_back = train(back_trainer, plain, 1)
    next_live = train(trainer, state, 1)
    print(f"[mesh] (c) {gpu}: the mesh TrainState, {nbytes:,} B, through "
          f"the collective DCP path (the manager's gloo group): async save "
          f"{stall_s:.3f} s on the host to enqueue, written {write_s:.2f} s "
          f"after it began ({nbytes / write_s / 1e9:.3f} GB/s, the first "
          f"save: its buffers allocated in it); "
          f"restore onto the unsharded layout {restore_plain_s:.2f} s "
          f"(step {at}; {len(same_plain)} of {len(saved)} tensors "
          f"bit-equal); the next step's loss {next_back[0][0]!r} restored "
          f"(unsharded) vs {next_live[0][0]!r} live (mesh)")
    if (len(same_plain) != len(saved) or next_back[0] != next_live[0]
            or next_back[1] != next_live[1] or at != TRAIN_STEPS):
        fail("the checkpoint round trip through the unsharded layout is "
             "not exact")
    mgr.close()
    del plain, back_trainer, trainer, state, saved
    gc.collect()    # FSDP2's hooks hold cycles
    torch.cuda.empty_cache()

    # ---- (d) a live reshard through TrainLoop before step 5 -------------
    model_rules = [PartitionRule(r.pattern, tuple(
        None if e == "fsdp" else e for e in r.spec)) for r in rules]
    trainer = sharded(tcfg, p0())
    state = trainer.state()
    seen = []

    def signal():
        seen.append(len(seen) + 1)
        if len(seen) != 5:
            return None
        return ReshardNotice(
            mesh, rules, mesh, model_rules, tag="flagship->model",
            step_builder=lambda m, st: Trainer(
                st.model, st.optimizer, rules=model_rules, mesh=m).train_step)

    from tpu_on_k8s_torch.obs.trace import Tracer
    tracer = Tracer(time.monotonic)
    batch = trainer.shard_batch(tokens)
    reset_counts(mods)
    result = trainer.fit(state, (batch for _ in range(TRAIN_STEPS)),
                         TRAIN_STEPS, log_every=1, reshard_signal=signal,
                         tracer=tracer)
    torch.cuda.synchronize()
    paths["mesh_reshard"] = read_counts(mods)
    loop_losses = [h["loss"] for _, h in result.history]
    loop_diff = first_difference(loop_losses, losses)
    new_rules = result.state.model.layout.rules
    span = next(sp["attrs"] for sp in tracer.export()
                if sp["name"] == "train.reshard")
    print(f"[mesh] (d) TrainLoop with a ReshardNotice before step 5 (the "
          f"flagship rules -> the model-only rules, same mesh): reshards "
          f"{result.reshards}, n_moved {span['leaves_moved']}, bytes_moved "
          f"{span['bytes_moved']:,} (a world of 1 holds every tensor whole "
          f"under either layout: no leaf moves); the state moved into a "
          f"fresh model laid out under the new rules in "
          f"{span['seconds']:.2f} s; losses "
          f"{'equal (a)' if not loop_diff else 'differ at ' + loop_diff}; "
          f"launches {paths['mesh_reshard']}")
    if (result.reshards != 1 or result.steps != TRAIN_STEPS or loop_diff
            or tuple(new_rules) != tuple(model_rules)):
        fail("the live reshard did not continue the trajectory")
    del trainer, state, result
    gc.collect()    # FSDP2's hooks hold cycles
    torch.cuda.empty_cache()

    # ---- (b) every int8 flag on the mesh --------------------------------
    torch.cuda.reset_peak_memory_stats()
    trainer = sharded(i8cfg, fuse_gateup(p0(), tcfg.n_layers))
    state = trainer.state()
    reset_counts(mods)
    losses8, _, step8_ms = train(trainer, state, TRAIN_STEPS)
    paths["mesh_int8"] = read_counts(mods)
    peak8_gb = torch.cuda.max_memory_allocated() / 1e9
    int8_per_step = paths["mesh_int8"]["int8_matmul"] / TRAIN_STEPS
    diff8 = first_difference(losses8, p4["losses8"])
    print(f"[mesh] (b) every int8 flag on the mesh: {int8_per_step:g} "
          f"int8_matmul launches a step; loss {[round(x, 5) for x in losses8]}"
          f" ({'equal phase 4b' if not diff8 else 'differ at ' + diff8}); "
          f"{gpu}: median step {statistics.median(step8_ms[1:]):.1f} ms "
          f"(phase 4b {p4['ms8']:.1f} ms), peak {peak8_gb:.2f} GB (phase 4b "
          f"{p4['peak8_gb']:.2f} GB)")
    if int8_per_step != (4 + 2 + 1) * tcfg.n_layers + 1 or diff8:
        fail(f"int8 mesh training: launches {paths['mesh_int8']}, losses "
             f"{losses8} vs {p4['losses8']}")
    del trainer, state
    gc.collect()    # FSDP2's hooks hold cycles
    torch.cuda.empty_cache()

    # ---- (f) the per-device FLOP count on the mesh, and mfu -------------
    trainer = sharded(tcfg, p0())
    state = trainer.state()
    batch = trainer.shard_batch(tokens)
    t0 = time.perf_counter()
    flops8, step_fn = train_step_flops(trainer, state, batch)
    count_s = time.perf_counter() - t0
    gauges = TrainMetrics()
    TrainLoop(step_fn, state, (batch for _ in range(4)), log_every=2,
              metrics=gauges, tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
              flops_per_step=flops8, peak_flops=PEAK_BF16_FLOPS).run(4)
    mfu = gauges.gauges.get("mfu", float("nan"))
    print(f"[mesh] (f) {gpu}: train_step_flops of (a)'s trainer on the mesh "
          f"(this rank's count, LocalFlopCounter) {flops8:.6e} FLOPs a step "
          f"against phase 4c's meshless {p4['flops']:.6e}: "
          f"{'equal' if flops8 == p4['flops'] else 'differ'} (counted in "
          f"{count_s:.1f} s); TrainLoop on the mesh, 4 steps, log_every 2: "
          f"mfu gauge {mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
          f"bf16 dense, step_seconds {gauges.gauges['step_seconds']:.4f}")
    if flops8 != p4["flops"] or not (math.isfinite(mfu) and mfu > 0):
        fail(f"the mesh FLOP count {flops8} (phase 4c {p4['flops']}) or its "
             f"mfu {mfu}")
    del trainer, state, step_fn
    gc.collect()    # FSDP2's hooks hold cycles
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"[time] phase 8 {time.perf_counter() - t_phase:.1f} s")
    return paths

def mesh_serve_phase(cfg, mods, gpu, dev, plain_a, serving, convert,
                     metrics_mod) -> dict:
    """Phase 9: mesh-sharded serving at llama2_7b width on a world of one
    rank (module docstring). Returns the launches of its mesh paths:
    ``mesh_serve`` (the mesh engines of (a)), ``mesh_serve_w8`` (the
    W8A16 tree's quantization and its mesh engine, (b)) and
    ``mesh_serve_int8`` (the int8-recipe mesh engine of (f))."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.parallel.mesh import serving_mesh
    from tpu_on_k8s_torch.parallel.serving import shutdown_mesh_workers
    from tpu_on_k8s_torch.parallel.sharded import TensorParallel
    from tpu_on_k8s_torch.serve import (
        FleetRolloutPolicy,
        ProbeConfig,
        Rejected,
        ServingFleet,
    )
    from tpu_on_k8s_torch.train.distributed import initialize

    t_phase = time.perf_counter()
    paths = {}
    # phase 3's weights, made again from its seed (the tensors phase 3
    # made were freed before training)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ctx = initialize({"RANK": "0", "WORLD_SIZE": "1",
                      "MASTER_ADDR": "localhost",
                      "MASTER_PORT": str(free_port())}, device=dev)
    mesh = serving_mesh(model=1, device=dev)
    print(f"[mesh-serve] world {dist.get_world_size()} (backend "
          f"{dist.get_backend()}, coordinator {ctx.coordinator_address}): "
          f"serving_mesh(model=1) on {mesh.device_type}")
    reqs = [(prompt, min(n, MESH_NEW)) for prompt, n in
            engine_traffic(cfg.vocab_size)[0][:MESH_REQUESTS]]
    shape = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                 clock=time.monotonic, device=dev)

    def serve(key, tree_cfg, tree, also=(), **kw):
        gc.collect()        # drive_engine's wrapper ties an engine in a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine = serving.ContinuousBatchingEngine(tree_cfg, tree, **shape,
                                                  **kw)
        shared = all(t.data_ptr() == tree[n].data_ptr()
                     for model in (engine._prefill_model,
                                   engine._step_model)
                     for n, t in model.named_parameters())
        run = drive_engine(engine, reqs, None, set(), mods, time.monotonic,
                           also=also)
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["shared"] = shared
        run["pages_in_use"] = engine.pages_in_use
        print(f"[mesh-serve] {key}: {len(run['tokens'])} requests, "
              f"{run['emitted']} tokens; flash_fwd {run['launched']['flash_fwd']}"
              f" = {tree_cfg.n_layers} x {run['fresh']} fresh prefills; "
              f"models hold the given tensors: {shared}; {gpu}: decode step "
              f"at occupancy {ENGINE_SLOTS} median "
              f"{statistics.median(run['step_ms']):.2f} ms over "
              f"{len(run['step_ms'])} steps; peak {run['peak_gb']:.2f} GB")
        return engine, run

    # ---- (a) dense and paged, meshless and on the mesh --------------------
    runs = {}
    paged = {"kv_pages": ENGINE_PAGES, "page_tokens": 128}
    for kind, kw in (("dense", {}), ("paged", paged)):
        runs[kind] = serve(f"(a) {kind}, meshless", cfg, params, **kw)[1]
        reset_counts(mods)
        engine, run = serve(f"(a) {kind}, mesh", cfg, params, mesh=mesh,
                            **kw)
        paths[f"mesh_serve_{kind}"] = read_counts(mods)
        runs[f"mesh_{kind}"] = run
        same = all(np.array_equal(run["tokens"][j], runs[kind]["tokens"][j])
                   for j in run["tokens"])
        print(f"[mesh-serve] (a) {kind}: mesh tokens equal the meshless "
              f"engine's token for token: {same}; flash launches "
              f"{run['launched']['flash_fwd']} vs "
              f"{runs[kind]['launched']['flash_fwd']}")
        if (not same or not run["shared"] or run["pages_in_use"]
                or run["launched"] != runs[kind]["launched"]):
            fail(f"the world-1 mesh engine ({kind}) differs from the "
                 f"meshless one")
        del engine
    # the host cost of the mesh's calls in a decode step: a decode
    # command's header, a pickled command (with a program that does
    # nothing), an all-reduce of a row-parallel product and the logits'
    # all-gather, each on its one-rank group
    engine = serving.ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                              **shape)
    tp = engine._prefill_model.head_tp
    x = torch.zeros(ENGINE_SLOTS, 1, cfg.d_model, dtype=cfg.dtype,
                    device=dev)
    y = torch.zeros(ENGINE_SLOTS, 1, cfg.vocab_size, device=dev)
    step_args = dict(toks=np.zeros(ENGINE_SLOTS, np.int32),
                     pos=np.zeros(ENGINE_SLOTS, np.int32), tables=None)
    host_us = {}
    for name, call in (("header", lambda: engine._channel.send(
                            engine._eid, "decode", step_args)),
                       ("pickled", lambda: engine._run("reset", handles=[])),
                       ("all_reduce", lambda: tp.reduce(x)),
                       ("all_gather", lambda: tp.gather(y))):
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    n_reduce = 2 * cfg.n_layers + 1       # wo and w_down a layer, the embed
    print(f"[mesh-serve] (a) {gpu}: host us a call on the one-rank groups: "
          f"decode command header {host_us['header']:.1f}, pickled command "
          f"{host_us['pickled']:.1f}, all_reduce "
          f"[{ENGINE_SLOTS}, 1, {cfg.d_model}] {host_us['all_reduce']:.1f}, "
          f"all_gather [{ENGINE_SLOTS}, 1, {cfg.vocab_size}] fp32 "
          f"{host_us['all_gather']:.1f}; a decode step's {n_reduce} "
          f"all-reduces, one gather and one header: "
          f"{(n_reduce * host_us['all_reduce'] + host_us['all_gather'] + host_us['header']) / 1e3:.2f} ms")
    del engine, tp, x, y
    dense_3e = all(np.array_equal(
        runs["dense"]["tokens"][j],
        plain_a["tokens"][j][:len(runs["dense"]["tokens"][j])])
        for j in range(MESH_REQUESTS))
    print(f"[mesh-serve] (a) {gpu}: decode step median "
          f"{statistics.median(runs['mesh_dense']['step_ms']):.2f} ms on the "
          f"mesh, {statistics.median(runs['dense']['step_ms']):.2f} ms "
          f"meshless, 3e (a) {statistics.median(plain_a['step_ms']):.2f} ms; "
          f"peak {runs['mesh_dense']['peak_gb']:.2f} GB on the mesh, "
          f"{runs['dense']['peak_gb']:.2f} GB meshless; the meshless tokens "
          f"equal the first {MESH_NEW} or fewer of 3e (a)'s first "
          f"{MESH_REQUESTS}: {dense_3e}")

    # ---- (b) the W8A16 tree ----------------------------------------------
    reset_counts(mods)
    wcfg, wparams = convert.quantize_serving_tree(cfg, params,
                                                  stochastic=True,
                                                  seed=W8_SEED)
    engine, w8_mesh = serve("(b) W8A16, mesh", wcfg, wparams, mesh=mesh)
    paths["mesh_serve_w8"] = read_counts(mods)
    del engine
    w8_plain = serve("(b) W8A16, meshless", wcfg, wparams)[1]
    same = all(np.array_equal(w8_mesh["tokens"][j], w8_plain["tokens"][j])
               for j in w8_mesh["tokens"])
    print(f"[mesh-serve] (b) W8A16: {paths['mesh_serve_w8']['quantize_int8']}"
          f" quantize launches; mesh tokens equal the meshless engine's: "
          f"{same}")
    if not same or not paths["mesh_serve_w8"]["quantize_int8"]:
        fail("the world-1 mesh W8A16 engine differs from the meshless one")
    del wparams

    # ---- (c) exports both ways ---------------------------------------------
    prompt, n = reqs[MESH_MOVED]
    moved = {}
    for src_mesh, key in ((mesh, "mesh -> meshless"),
                          (None, "meshless -> mesh")):
        # fresh engines (zeros past every cached position), the request on
        # both to the same step: the source exports it, the destination's
        # own copy runs on uninterrupted
        src = serving.ContinuousBatchingEngine(cfg, params, mesh=src_mesh,
                                               **shape)
        dst = serving.ContinuousBatchingEngine(
            cfg, params, mesh=None if src_mesh is not None else mesh,
            **shape)
        r, twin = src.submit(prompt, n), dst.submit(prompt, n)
        for _ in range(MESH_MOVE_STEPS):
            src.step()
            dst.step()
        t0 = time.perf_counter()
        h = src.export_kv(r)
        export_ms = (time.perf_counter() - t0) * 1e3
        src.abort(r)
        same_bytes = h.checksum == dst.export_kv(twin).checksum
        want = dst.run()[twin]
        r2 = dst.submit_kv(h, n)
        got = dst.run()[r2]
        moved[key] = (h.verify(), same_bytes, np.array_equal(got, want))
        print(f"[mesh-serve] (c) {key}: {h.nbytes} B at position {h.pos}, "
              f"layout {h.layout.mesh_axes}, export {export_ms:.2f} ms; "
              f"verifies {moved[key][0]}; checksum equal to the other "
              f"engine's export at the same step {same_bytes}; continuation "
              f"equal to the uninterrupted copy's {moved[key][2]}")
        del src, dst
    if not all(all(v) for v in moved.values()):
        fail(f"a world-1 export across the mesh boundary failed: {moved}")

    # ---- (d) the shard surface ---------------------------------------------
    sm = metrics_mod.ShardMetrics()
    report_eng = serving.ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                                  shard_metrics=sm, **shape)
    rep = report_eng.shard_report()
    axes = {k[1]: v for k, v in sm.gauges.items()
            if k[0] == "mesh_axis_size"}
    print(f"[mesh-serve] (d) shard_report {rep}; ShardMetrics mesh axes "
          f"{axes}, param_bytes_per_chip "
          f"{sm.gauges[('param_bytes_per_chip', '')]:.0f}")
    if (rep["param_bytes_per_chip"] != rep["param_bytes_total"]
            or rep["kv_bytes_per_chip"] != rep["kv_bytes_total"]
            or rep["n_chips"] != 1 or set(axes.values()) != {1}
            or sm.gauges[("kv_bytes_per_chip", "")]
            != rep["kv_bytes_total"]):
        fail(f"the world-1 shard surface is not the identity: {rep}")
    del report_eng

    # ---- (e) a fleet rolled onto mesh replicas ---------------------------
    def plain_factory(name):
        return serving.ContinuousBatchingEngine(cfg, params, **shape)

    def mesh_factory(name):
        return serving.ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                                **shape)

    fleet = ServingFleet(plain_factory, 2,
                         probe=ProbeConfig(slow_start_steps=1),
                         shard_metrics=metrics_mod.ShardMetrics())
    rids = []
    for _ in range(3):
        fleet.step()
    for j, (prompt, n) in enumerate(reqs):
        if j == MESH_REQUESTS // 2:
            fleet.start_rollout(mesh_factory, "v1-mesh", FleetRolloutPolicy(
                max_surge=1, drain_timeout_s=None))
        r = fleet.submit(prompt, n)
        if isinstance(r, Rejected):
            fail(f"the fleet rejected request {j}: {r}")
        rids.append(r)
        fleet.step()
    out = fleet.run()
    states = {out[r].state.value for r in rids if r in out}
    live = [rep.engine.mesh is not None for rep in fleet.replicas.values()
            if rep.engine is not None]
    print(f"[mesh-serve] (e) fleet: rollout {fleet.rollout_phase.value}, "
          f"{len([r for r in rids if r in out])}/{len(rids)} requests "
          f"{states}; live replicas on the mesh {live}; reshard_rollouts "
          f"{fleet.stats['reshard_rollouts']} (the world-1 mesh signature "
          f"is {{}} on both sides)")
    if (fleet.rollout_phase.value != "complete" or states != {"done"}
            or len(out) != len(rids) or not live or not all(live)):
        fail("the fleet's roll onto mesh replicas lost requests")
    del fleet, out
    gc.collect()

    # ---- (f) the int8 recipes and the fused rows on the mesh -------------
    # phase 3c's recipe with the fused layouts, on phase 3's weights fused
    # (the unfused tree freed): the MLP's and the head's products on the
    # int8 kernel, w_down row parallel (its absmax all-reduced, its fp32
    # partial products summed, on the one-rank group)
    icfg = dataclasses.replace(cfg, mlp_int8=True, head_int8=True,
                               mlp_fused_gateup=True, fused_qkv=True,
                               int8_impl="pallas")
    fused = fuse_qkv(fuse_gateup(params, cfg.n_layers), cfg.n_layers)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    also = ("int8_matmul",)
    int8_plain = serve("(f) int8 recipe + fused, meshless", icfg, fused,
                       also=also)[1]
    # the collectives of the model axis, counted over the mesh run
    calls = {"reduce_max": 0, "reduce": 0}
    originals = {name: getattr(TensorParallel, name) for name in calls}

    def counted(name):
        def call(self, t):
            calls[name] += 1
            return originals[name](self, t)
        return call

    for name in calls:
        setattr(TensorParallel, name, counted(name))
    try:
        reset_counts(mods)
        int8_mesh = serve("(f) int8 recipe + fused, mesh", icfg, fused,
                          mesh=mesh, also=also)[1]
        paths["mesh_serve_int8"] = read_counts(mods)
    finally:
        for name, call in originals.items():
            setattr(TensorParallel, name, call)
    same = all(np.array_equal(int8_mesh["tokens"][j], int8_plain["tokens"][j])
               for j in int8_mesh["tokens"])
    n8 = (int8_mesh["launched"]["int8_matmul"],
          int8_plain["launched"]["int8_matmul"])
    print(f"[mesh-serve] (f) mlp_int8 + head_int8 + mlp_fused_gateup + "
          f"fused_qkv, int8_impl pallas: mesh tokens equal the meshless "
          f"engine's token for token: {same}; int8_matmul launches mesh "
          f"{n8[0]}, meshless {n8[1]}; on the one-rank group the row-parallel "
          f"w_down's all-reduce-max ran {calls['reduce_max']} times (x and "
          f"w a call), the sums {calls['reduce']} times (wo, w_down, the "
          f"embedding); {gpu}: decode step median "
          f"{statistics.median(int8_mesh['step_ms']):.2f} ms on the mesh, "
          f"{statistics.median(int8_plain['step_ms']):.2f} ms meshless "
          f"((a) dense: {statistics.median(runs['mesh_dense']['step_ms']):.2f}"
          f" / {statistics.median(runs['dense']['step_ms']):.2f} ms); peak "
          f"{int8_mesh['peak_gb']:.2f} / {int8_plain['peak_gb']:.2f} GB "
          f"((a) dense: {runs['mesh_dense']['peak_gb']:.2f} / "
          f"{runs['dense']['peak_gb']:.2f} GB)")
    if (not same or n8[0] != n8[1] or not n8[0]
            or not calls["reduce_max"] or calls["reduce_max"] % 2
            or calls["reduce"] < calls["reduce_max"] // 2):
        fail(f"the world-1 int8-recipe mesh engine: tokens equal {same}, "
             f"int8 launches {n8}, collectives {calls}")
    del fused
    gc.collect()
    shutdown_mesh_workers()
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"[time] phase 9 {time.perf_counter() - t_phase:.1f} s")
    return paths


def resnet_gate(dev, vision, load_module) -> float:
    """Phase 10 (a)'s gate: ResNet-50 in fp32, every BatchNorm's scale and
    bias drawn from a seed (the reference's zero bn3 scale would leave each
    block's main branch out), a train-mode forward on 8 images on the card
    and on the CPU from the same weights. Returns max|card − CPU| over
    max|CPU|."""
    cfg = dataclasses.replace(vision.ResNetConfig.resnet50(),
                              dtype=torch.float32)
    with torch.device("meta"):
        shape = vision.ResNet(cfg)
    gen = torch.Generator().manual_seed(RESNET_SEED)
    values = vision.init_variables(shape, gen)
    for name, t in values.items():
        if name.endswith(".scale"):
            values[name] = 1 + 0.3 * torch.randn(t.shape, generator=gen)
        elif ".bn" in name and name.endswith(".bias"):
            values[name] = 0.2 * torch.randn(t.shape, generator=gen)
    x = torch.from_numpy(np.random.default_rng(RESNET_SEED).standard_normal(
        (8, 224, 224, 3), dtype=np.float32))
    with torch.device("meta"):
        cpu_model, card_model = vision.ResNet(cfg), vision.ResNet(cfg)
    cpu_model = load_module(cpu_model, {k: v.clone()
                                        for k, v in values.items()}, "cpu")
    card_model = load_module(card_model, values, dev)
    with torch.no_grad():
        want = cpu_model(x, train=True)
        got = card_model(x.to(dev), train=True).cpu()
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"[vision] (a) gate: resnet50 fp32, train-mode forward of 8 "
          f"images on the card (TF32 off) against the CPU, same weights "
          f"(BatchNorm scales and biases from seed {RESNET_SEED}): "
          f"max|card - cpu| / max|cpu| {err:.3e} (tol {RESNET_GATE_TOL:g})")
    if not err <= RESNET_GATE_TOL or not torch.isfinite(got).all():
        fail("the card's fp32 ResNet-50 forward differs from the CPU's")
    return err


#: what a kernel's time counts as: the group of the first of these marks
#: found in the names of the ops around the op that launched it, innermost
#: first (``chip_smoke.batch_norm`` is the range ``profiled_step`` opens
#: around each BatchNorm's forward; ``aten::convolution`` also marks
#: ``aten::convolution_backward``)
PROFILE_GROUPS = (
    ("BatchNorm forward", ("chip_smoke.batch_norm",)),
    ("BatchNorm backward", ("_BatchNormTrainBackward",)),
    ("convolutions", ("aten::convolution", "ConvolutionBackward")),
    ("optimizer", ("Optimizer.step",)),
)
_EVALUATE = "autograd::engine::evaluate_function: "


def _op_chain(e):
    """The names of a profiled op and of the ops around it, innermost
    first."""
    while e is not None:
        yield e.name
        e = e.cpu_parent


def attribute_kernels(events, kernels_of=None):
    """Each device kernel of a profile's ``events()`` counted once, to the
    CPU op that launched it: ({group: ms} over ``PROFILE_GROUPS`` and "the
    rest"; of the rest, {op: ms} by the outermost aten op or autograd node
    around the launch, and {kernel: ms}). ``kernels_of(event)`` gives an
    op's (name, µs) kernels (default: the ones the profiler linked to
    it)."""
    from torch.autograd import DeviceType

    if kernels_of is None:
        def kernels_of(e):
            return [(k.name, k.duration) for k in e.kernels]
    groups = dict.fromkeys([g for g, _ in PROFILE_GROUPS] + ["the rest"],
                           0.0)
    rest_ops, rest_kernels = {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        kernels = kernels_of(e)
        if not kernels:
            continue
        chain = list(_op_chain(e))
        group = next((g for name in chain for g, marks in PROFILE_GROUPS
                      if any(m in name for m in marks)), "the rest")
        ms = sum(us for _, us in kernels) / 1e3
        groups[group] += ms
        if group == "the rest":
            ops = [n for n in chain if n.startswith(("aten::", _EVALUATE))]
            op = (ops[-1] if ops else chain[-1]).replace(_EVALUATE, "")
            rest_ops[op] = rest_ops.get(op, 0.0) + ms
            for name, us in kernels:
                rest_kernels[name] = rest_kernels.get(name, 0.0) + us / 1e3
    return groups, rest_ops, rest_kernels


def profiled_step(step, model, marked_cls, n_top: int = 8) -> str:
    """One ``step()`` under ``torch.profiler`` (CPU and CUDA activity):
    its device time by ``attribute_kernels``, each module of
    ``marked_cls`` in ``model`` run inside a ``chip_smoke.batch_norm``
    range for this step only, with the ``n_top`` longest ops and kernels
    of the rest, beside every device kernel the profile holds."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    open_ranges, handles = {}, []

    def enter(module, _args):
        open_ranges[id(module)] = rf = record_function(
            "chip_smoke.batch_norm")
        rf.__enter__()

    def leave(module, _args, _out):
        open_ranges.pop(id(module)).__exit__(None, None, None)

    for module in model.modules():
        if isinstance(module, marked_cls):
            handles += [module.register_forward_pre_hook(enter),
                        module.register_forward_hook(leave)]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    events = prof.events()
    groups, rest_ops, rest_kernels = attribute_kernels(events)
    total = sum(groups.values())
    if not total:
        return "no device time seen by the profiler (not measured)"
    every = sum(e.device_time_total for e in events
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)) / 1e3

    def top(d):
        return "; ".join(f"{k[:70]} {d[k]:.2f} ms" for k in
                         sorted(d, key=d.get, reverse=True)[:n_top])

    return (f"{total:.2f} ms of kernels attributed to the ops that launched "
            f"them (the profile's device kernels: {every:.2f} ms): "
            + ", ".join(f"{g} {t:.2f} ms ({t / total:.1%})"
                        for g, t in groups.items())
            + f". The rest by op: {top(rest_ops)}. The rest by kernel: "
            + top(rest_kernels))


def resnet_throughput(dev, gpu, vision, load_module, popt, trainer_cls,
                      batch: int) -> dict:
    """Phase 10 (a): ResNet-50 bf16, ``ClassifierTrainer`` with adam(1e-3)
    on one card, ``VISION_STEPS`` steps on one fixed batch of ``batch`` x
    224 x 224 x 3 NHWC images from numpy, each step ending in a
    synchronize."""
    cfg = vision.ResNetConfig.resnet50()
    with torch.device("meta"):
        model = vision.ResNet(cfg)
    gen = torch.Generator(device=dev).manual_seed(RESNET_SEED)
    model = load_module(model, vision.init_variables(model, gen), dev)
    trainer = trainer_cls(model, popt.adam(model.parameters(), 1e-3))
    rng = np.random.default_rng(RESNET_SEED + 1)
    images = torch.from_numpy(rng.standard_normal(
        (batch, 224, 224, 3), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes,
                                           (batch,))).to(dev)
    before = {n: b.clone() for n, b in model.named_buffers()}
    state = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(VISION_STEPS):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 2**30
    split = profiled_step(lambda: trainer.train_step(state, images, labels),
                          model, vision.BatchNorm)
    moved = sum(not torch.equal(before[n], b)
                for n, b in model.named_buffers())
    finite = all(torch.isfinite(b).all() for b in model.buffers())
    step_s = statistics.median(times[1:])
    print(f"[time] {gpu}: resnet50 bf16 train step (ClassifierTrainer, "
          f"adam 1e-3, fp32 masters, one card) batch {batch} x 224 x 224 x "
          f"3: median of steps 2-{VISION_STEPS} {step_s * 1e3:.2f} ms, "
          f"{batch / step_s:,.1f} images/s, peak memory {peak:.2f} GB; "
          f"BASELINE.json's v5e reading {V5E_IMAGES_S} images/s/chip (a "
          f"TPU's, beside it as a reading, not a target)")
    print(f"[vision] (a) one more step under torch.profiler: {split}")
    print(f"[vision] (a) losses {[round(l, 4) for l in losses]}; "
          f"{moved} of {len(before)} BatchNorm buffers moved in train "
          f"mode, all finite: {finite}")
    if moved != len(before) or not finite:
        fail("train mode did not move every BatchNorm buffer, or left one "
             "not finite")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"ResNet-50's loss did not fall over {VISION_STEPS} adam steps "
             f"on one batch: {losses}")
    return dict(batch=batch, step_ms=step_s * 1e3, peak_gb=peak,
                images_s=batch / step_s, profile=split)


def bert_batch(cfg, batch: int, seq: int, seed: int, padded: bool):
    """(tokens, MLM mask, padding mask or None) on numpy seeds: 15% of the
    positions masked; with ``padded`` each row's real length drawn in
    64 ... seq from ``BERT_LEN_SEED``."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    mlm = torch.from_numpy((rng.uniform(size=(batch, seq)) < 0.15).astype(
        np.float32))
    if not padded:
        return tokens, mlm, None
    lengths = np.random.default_rng(BERT_LEN_SEED).integers(64, seq + 1,
                                                            batch)
    mask = torch.from_numpy((np.arange(seq)[None] < lengths[:, None]).astype(
        np.int32))
    return tokens, mlm * mask, mask


def vision_bert_phase(mods, gpu, dev, tmp, fa) -> dict:
    """Phase 10: the vision models and BERT (see the module docstring).
    Returns the launches of its paths and the flash kernels' rows at
    BERT's padded shape."""
    import contextlib
    import io

    from tpu_on_k8s_torch import train_bert, train_mnist, train_resnet
    from tpu_on_k8s_torch.models import bert, vision
    from tpu_on_k8s_torch.models.params import load_module
    from tpu_on_k8s_torch.train import optimizer as popt
    from tpu_on_k8s_torch.train.mlm import make_mlm_step
    from tpu_on_k8s_torch.train.vision import ClassifierTrainer

    t_phase = time.perf_counter()
    paths = {}
    # ---- (a) ResNet-50 --------------------------------------------------
    resnet_gate(dev, vision, load_module)
    resnet = None
    for batch in RESNET_BATCHES:
        try:
            resnet = resnet_throughput(dev, gpu, vision, load_module, popt,
                                       ClassifierTrainer, batch)
            break
        except torch.OutOfMemoryError:
            print(f"[vision] (a) batch {batch} does not fit the card "
                  f"(out of memory); trying the next")
        finally:
            gc.collect()
            torch.cuda.empty_cache()
    if resnet is None:
        fail(f"ResNet-50 fits none of the batches {RESNET_BATCHES}")
    if resnet["batch"] != RESNET_BATCHES[0]:
        print(f"[vision] (a) finding: batch {RESNET_BATCHES[0]} did not "
              f"fit; {resnet['batch']} is the largest tried that does, "
              f"peak {resnet['peak_gb']:.2f} GB")

    # ---- (b) the vision CLIs at their defaults ---------------------------
    t0 = time.perf_counter()
    reset_counts(mods)
    outs = {}
    for name, cli, argv in (("train_mnist", train_mnist, []),
                            ("train_resnet --tiny", train_resnet,
                             ["--tiny"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = cli.main(argv)
        lines = [l for l in buf.getvalue().splitlines()
                 if l.startswith("[elastic-metrics]")]
        outs[name] = (loss, len(lines), lines[-1] if lines else "")
    torch.cuda.synchronize()
    for name, (loss, n, last) in outs.items():
        print(f"[vision] (b) python -m tpu_on_k8s_torch.{name} (defaults, "
              f"cuda): final loss {loss:.5f}, {n} [elastic-metrics] lines, "
              f"the last: {last}")
        if not math.isfinite(loss) or n != 50:
            fail(f"{name} at its defaults did not train 50 finite steps")
    print(f"[vision] (b) {time.perf_counter() - t0:.1f} s")

    # ---- (c) BERT-base, attn xla ------------------------------------------
    cfg = bert.BertConfig.base()
    gen = torch.Generator(device=dev).manual_seed(BERT_SEED)
    masters = bert.init_params(cfg, gen)

    def model_of(impl="xla", dtype=torch.bfloat16):
        """A ``Bert`` on the masters themselves (no copy)."""
        with torch.device("meta"):
            m = bert.Bert(dataclasses.replace(cfg, attn_impl=impl,
                                              dtype=dtype))
        return load_module(m, masters, dev)

    model = model_of()
    opt = popt.adamw(model.parameters(), popt.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)
    step = make_mlm_step(model, opt)
    tokens, mlm, _ = (t.to(dev) if t is not None else None for t in
                      bert_batch(cfg, *BERT_XLA_SHAPE, BERT_SEED, False))
    reset_counts(mods)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        losses.append(step(tokens, mlm)["loss"].item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = statistics.median(times[1:])
    b, l = BERT_XLA_SHAPE
    print(f"[time] {gpu}: bert_base bf16 train step (attn xla, adamw, fp32 "
          f"masters) batch {b} x {l}: median of steps 2-{BERT_STEPS} "
          f"{step_s * 1e3:.2f} ms, {b * l / step_s:,.0f} tokens/s, peak "
          f"memory {peak:.2f} GB; losses {[round(x, 4) for x in losses]}")
    if abs(losses[0] - math.log(cfg.vocab_size)) >= 1.0 or not all(
            map(math.isfinite, losses)):
        fail(f"BERT-base's step-0 loss {losses[0]} is not within 1.0 of "
             f"ln({cfg.vocab_size})")
    del model, opt, step
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = train_bert.main(["--steps", str(BERT_CLI_STEPS)])
    lines = [l for l in buf.getvalue().splitlines()
             if l.startswith("[elastic-metrics]")]
    print(f"[vision] (c) python -m tpu_on_k8s_torch.train_bert --steps "
          f"{BERT_CLI_STEPS} (defaults otherwise: bert_base, 8 x 128, xla, "
          f"cuda): final loss {loss:.5f}, {len(lines)} lines, the last: "
          f"{lines[-1] if lines else ''}")
    if not math.isfinite(loss) or len(lines) != BERT_CLI_STEPS:
        fail(f"train_bert did not train {BERT_CLI_STEPS} finite steps")

    # ---- (d) BERT-base, attn flash, a padding mask ------------------------
    # fresh masters from the seed: (c)'s steps moved the first ones
    masters = bert.init_params(cfg, gen.manual_seed(BERT_SEED))
    b, l = BERT_FLASH_SHAPE
    tokens, mlm, mask = (t.to(dev) for t in
                         bert_batch(cfg, b, l, BERT_SEED + 1, True))
    real = mask.bool()
    flash, xla32 = model_of("flash"), model_of("xla", torch.float32)
    xla = model_of("xla")
    reset_counts(mods)
    with torch.no_grad():
        logits_k = flash(tokens, None, mask)
        torch.cuda.synchronize()
        fwd_counts = read_counts(mods)
        logits_p = xla(tokens, None, mask)
        logits_32 = xla32(tokens, None, mask)
    dist_k = (logits_k - logits_32)[real].abs().max().item()
    dist_p = (logits_p - logits_32)[real].abs().max().item()
    del logits_k, logits_p, logits_32

    def twins():
        stack = contextlib.ExitStack()
        for name, plain in (("flash_with_lse_fwd", "flash_attention_plain"),
                            ("flash_bwd_dq", "flash_bwd_dq_plain"),
                            ("flash_bwd_dkv", "flash_bwd_dkv_plain")):
            stack.enter_context(mock.patch.object(fa, name,
                                                  getattr(fa, plain)))
        return stack

    def grads_of(model, patch=nullcontext):
        with patch():
            loss = bert.mlm_loss(model(tokens, None, mask), tokens, mlm)
            return dict(zip([n for n, _ in model.named_parameters()],
                            torch.autograd.grad(loss, list(
                                model.parameters()))))

    g32 = grads_of(xla32)

    def rel(g):
        # not the key biases: a key bias adds the same q·b to every score
        # of a query's row, which softmax cancels, so their gradient is 0
        # and every model's reading of it is rounding alone
        return {k: ((g[k].float() - g32[k]).norm() / g32[k].norm()).item()
                for k in g32 if not k.endswith(".wk.bias")}

    reset_counts(mods)
    gk = rel(grads_of(flash))
    torch.cuda.synchronize()
    grad_counts = read_counts(mods)
    gt, gp = rel(grads_of(flash, twins)), rel(grads_of(xla))
    vs_twins = {k: gk[k] / gt[k] for k in gk}
    vs_plain = {k: gk[k] / gp[k] for k in gk}
    worst_t = max(vs_twins, key=vs_twins.get)
    worst_p = max(vs_plain, key=vs_plain.get)

    def top(r):
        return ", ".join(f"{k} {r[k]:.3f}" for k in sorted(
            r, key=r.get, reverse=True)[:6])

    attn = [k for k in gk if re.search(r"\.w[qkv]\.", k)]

    def total(g, keys=tuple(gk)):
        """The distance of the tensors ``keys`` as one vector."""
        return math.sqrt(sum((g[k] * g32[k].norm().item()) ** 2
                             for k in keys)) / math.sqrt(sum(
            g32[k].norm().item() ** 2 for k in keys))

    whole = {name: total(g) for name, g in (("flash", gk), ("twins", gt),
                                            ("xla", gp))}
    qkv = {name: total(g, attn) for name, g in (("flash", gk),
                                                ("twins", gt), ("xla", gp))}
    print(f"[vision] (d) highest ratios, readings: against the twins "
          f"{top(vs_twins)}; against xla {top(vs_plain)}")
    lens = real.sum(1).tolist()
    print(f"[vision] (d) bert_base bf16, attn flash, batch {b} x {l}, real "
          f"lengths {lens} (numpy seed {BERT_LEN_SEED}): real-position "
          f"logits max|flash - fp32| {dist_k:.4e}, max|xla bf16 - fp32| "
          f"{dist_p:.4e}, ratio {dist_k / dist_p:.3f} (limit "
          f"{LOGITS_NOISE_MULT:g}); launches in the forward {fwd_counts}")
    print(f"[vision] (d) gradient gate, one step, {len(gk)} tensors, "
          f"||g - g_fp32|| / ||g_fp32||: all of them as one vector: flash "
          f"{whole['flash']:.4e}, xla bf16 {whole['xla']:.4e}, ratio "
          f"{whole['flash'] / whole['xla']:.3f} (limit {GRAD_NOISE_MULT:g})"
          f"; the {len(attn)} q/k/v projections' (what the kernels' "
          f"gradients feed) as one vector: flash {qkv['flash']:.4e}, the "
          f"twins' bf16 model (the kernels' arithmetic in plain PyTorch) "
          f"{qkv['twins']:.4e}, ratio {qkv['flash'] / qkv['twins']:.3f} "
          f"(limit {GRAD_NOISE_MULT:g}), xla {qkv['xla']:.4e}; per tensor "
          f"(readings) flash max {max(gk.values()):.4e}, median "
          f"{statistics.median(gk.values()):.4e}, against the twins "
          f"median {statistics.median(vs_twins.values()):.3f}, max "
          f"{vs_twins[worst_t]:.3f} at {worst_t}, against xla median "
          f"{statistics.median(vs_plain.values()):.3f}, max "
          f"{vs_plain[worst_p]:.3f} at {worst_p}; launches in the step's "
          f"forward and backward {grad_counts}")
    n = cfg.n_layers
    if (dist_k > LOGITS_NOISE_MULT * dist_p
            or whole["flash"] > GRAD_NOISE_MULT * whole["xla"]
            or qkv["flash"] > GRAD_NOISE_MULT * qkv["twins"]):
        fail("BERT's flash path strays further from the fp32 model than "
             "the bf16 plain path and the kernels' arithmetic explain")
    if [fwd_counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")] != [n, 0, 0] or [
            grad_counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")] != [n, n, n]:
        fail(f"BERT flash launches: forward {fwd_counts}, step "
             f"{grad_counts}; expected {n}/0/0 and {n}/{n}/{n}")
    del xla32, xla, g32
    gc.collect()
    torch.cuda.empty_cache()
    # training steps through make_mlm_step: launches a step and step ms
    opt = popt.adamw(flash.parameters(), popt.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)
    step = make_mlm_step(flash, opt)
    times, per_step = [], []
    for _ in range(4):
        reset_counts(mods)
        t0 = time.perf_counter()
        step(tokens, mlm, None, mask)["loss"].item()
        times.append(time.perf_counter() - t0)
        per_step.append(read_counts(mods))
    paths["bert_flash"] = {k: fwd_counts[k] + grad_counts[k]
                           + sum(c[k] for c in per_step)
                           for k in fwd_counts}
    step_s = statistics.median(times[1:])
    print(f"[time] {gpu}: bert_base bf16 train step (attn flash, padding "
          f"mask, adamw) batch {b} x {l}: median of steps 2-4 "
          f"{step_s * 1e3:.2f} ms, {b * l / step_s:,.0f} tokens/s "
          f"({sum(lens):,} real); launches a step {per_step[-1]}")
    if any([c[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
           != [n, n, n] for c in per_step):
        fail(f"a BERT training step launched {per_step}; expected "
             f"{n}/{n}/{n}")
    del flash, opt, step, masters
    gc.collect()
    torch.cuda.empty_cache()

    # the three kernels at this shape: against the plain twins, twice
    # launched bit for bit, timed beside SDPA with the equivalent mask
    h, d = cfg.n_heads, cfg.head_dim
    kg = torch.Generator(device=dev).manual_seed(BERT_SEED + 2)
    q, k, v, do = (torch.randn(b, h, l, d, generator=kg, device=dev).to(
        torch.bfloat16) for _ in range(4))
    seg = bert.padding_segments(mask)
    o, lse = fa.flash_with_lse_fwd(q, k, v, False, 0, seg)
    o2, lse2 = fa.flash_with_lse_fwd(q, k, v, False, 0, seg)
    po, plse = fa.flash_attention_plain(q, k, v, False, 0, seg)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, False, 0, seg)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, False, 0, seg)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, False, 0, seg)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, False, 0, seg)
    pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, False, 0, seg)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, False, 0,
                                      seg)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[torch.bfloat16]
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()

    def rel_err(a, w):
        return ((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item()

    errs = {"dq": rel_err(dq, pdq), "dk": rel_err(dk, pdk),
            "dv": rel_err(dv, pdv)}
    same = (torch.equal(o, o2) and torch.equal(lse, lse2)
            and torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2))
    shape = (f"B={b} H={h} L={l} D={d} bf16 non-causal, padding segments "
             f"(bert_base)")
    print(f"[kernel] {shape}: flash_fwd max|o-plain| {err_o:.3e} (tol "
          f"{tol_o:g}) max|lse-plain| {err_lse:.3e} (tol {tol_lse:g}); "
          f"flash_bwd dq rel {errs['dq']:.2e}, dk rel {errs['dk']:.2e}, dv "
          f"rel {errs['dv']:.2e} (tol rel {BWD_REL_TOL[torch.bfloat16]:g}); "
          f"two launches bit-identical: {same}")
    if (err_o > tol_o or err_lse > tol_lse
            or max(errs.values()) > BWD_REL_TOL[torch.bfloat16] or not same):
        fail(f"the flash kernels at BERT's padded shape: {shape}")
    keep = (seg[:, :, None] == seg[:, None, :])
    pairs = int(keep.sum())
    sdpa_mask = keep[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn, stream = sdpa_backward(q, k, v, do, attn_mask=sdpa_mask)
    sdpa_bwd = time_ms(fn, stream=stream)
    rows = {
        "flash_fwd": dict(
            ms=time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, False, 0,
                                                     seg)),
            plain_ms=plain_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, False, 0, seg)),
            library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=sdpa_mask)),
            max_abs_err=err_o,
            **dict(zip(("bound_ms", "bound_by"), flash_bound_ms(
                b, h, h, l, d, False, pairs)))),
        "flash_bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                               False, 0, seg)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dq_plain(
                q, k, v, do, lse, delta, False, 0, seg)),
            library_ms=sdpa_bwd,
            max_abs_err=(dq.float() - pdq.float()).abs().max().item(),
            **dict(zip(("bound_ms", "bound_by"), dq_bound_ms(
                b, h, h, l, d, False, pairs)))),
        "flash_bwd_dkv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                False, 0, seg)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, False, 0, seg)),
            library_ms=sdpa_bwd,
            max_abs_err=max((dk.float() - pdk.float()).abs().max().item(),
                            (dv.float() - pdv.float()).abs().max().item()),
            **dict(zip(("bound_ms", "bound_by"), dkv_bound_ms(
                b, h, h, l, d, False, pairs)))),
    }
    full = flash_bound_ms(b, h, h, l, d, False)[0]
    for name, r in rows.items():
        r.update(shape=shape, kept_pairs=pairs * h)
        print(f"[time] {gpu}: {name} {shape}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa with the boolean mask "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
              f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {pairs:,} kept pairs a head of "
              f"{b * l * l:,}), {r['bound_ms'] / r['ms']:.1%} of bound")
    print(f"[time] {gpu}: (the forward's bound over all {b * l * l:,} "
          f"pairs a head would be {full:.4f} ms)")

    # ---- (e) the model and seq axes --------------------------------------
    # the kernels at a rank's heads over a model axis of 2 and 4 (6 and 3
    # of BERT-base's 12), laid out as a rank's projections make them
    for heads in (h // 2, h // 4):
        hq, hk, hv, hdo = (t.transpose(1, 2)[:, :, :heads].contiguous()
                           .transpose(1, 2) for t in (q, k, v, do))
        ho, hlse = fa.flash_with_lse_fwd(hq, hk, hv, False, 0, seg)
        hpo, hplse = fa.flash_attention_plain(hq, hk, hv, False, 0, seg)
        hdelta = (hdo.float() * ho.float()).sum(-1)[:, :, None, :]
        got = (fa.flash_bwd_dq(hq, hk, hv, hdo, hlse, hdelta, False, 0, seg),
               *fa.flash_bwd_dkv(hq, hk, hv, hdo, hlse, hdelta, False, 0,
                                 seg))
        again = (fa.flash_bwd_dq(hq, hk, hv, hdo, hlse, hdelta, False, 0,
                                 seg),
                 *fa.flash_bwd_dkv(hq, hk, hv, hdo, hlse, hdelta, False, 0,
                                   seg))
        want = (fa.flash_bwd_dq_plain(hq, hk, hv, hdo, hlse, hdelta, False,
                                      0, seg),
                *fa.flash_bwd_dkv_plain(hq, hk, hv, hdo, hlse, hdelta, False,
                                        0, seg))
        torch.cuda.synchronize()
        herr_o = (ho.float() - hpo.float()).abs().max().item()
        herr_lse = (hlse - hplse).abs().max().item()
        hrels = [rel_err(a, w) for a, w in zip(got, want)]
        hsame = all(map(torch.equal, got, again))
        print(f"[kernel] (e) a rank's heads, B={b} H={heads} L={l} D={d} "
              f"bf16 non-causal, padding segments (bert_base over a model "
              f"axis of {h // heads}): max|o-plain| {herr_o:.3e} "
              f"max|lse-plain| {herr_lse:.3e}, rel dq {hrels[0]:.2e} dk "
              f"{hrels[1]:.2e} dv {hrels[2]:.2e}; two launches of the "
              f"backward bit-identical: {hsame}")
        if (herr_o > tol_o or herr_lse > tol_lse or not hsame
                or max(hrels) > BWD_REL_TOL[torch.bfloat16]):
            fail(f"the flash kernels at a rank's {heads} heads of BERT")
        del hq, hk, hv, hdo, ho, hlse, hpo, hplse, got, again, want
    del q, k, v, do, o, lse, o2, lse2, po, plse, dq, dq2, dk, dv, dk2, dv2
    torch.cuda.empty_cache()
    # the encoder's tensor parallelism and split sequence on a world-1
    # mesh: model and seq axes of one rank, laid out by the code that runs
    # them over more (shard_model calls it only for an axis over 1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from tpu_on_k8s_torch.parallel.mesh import (
        AXIS_MODEL,
        MeshConfig,
        create_mesh,
    )
    from tpu_on_k8s_torch.train.distributed import initialize

    initialize({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(free_port())}, device=dev)
    mesh = create_mesh(MeshConfig(model=1, seq=1), device=dev)
    masters = bert.init_params(cfg, gen.manual_seed(BERT_SEED))

    def logits_and_grads(model, **kw):
        out = model(tokens, None, mask, **kw)
        g = torch.autograd.grad(bert.mlm_loss(out, tokens, mlm),
                                list(model.parameters()))
        return out.detach(), {
            name: (t.full_tensor() if isinstance(t, DTensor) else t).float()
            for (name, _), t in zip(model.named_parameters(), g)}

    base_logits, base_grads = logits_and_grads(model_of("flash"))
    laid = model_of("flash")
    laid.tensor_parallel(mesh[AXIS_MODEL])
    laid.split_sequence(mesh)
    reset_counts(mods)
    mesh_logits, mesh_grads = logits_and_grads(laid, seq_chunk=True)
    torch.cuda.synchronize()
    paths["bert_model_seq_mesh"] = launched = read_counts(mods)
    logit_diff = (mesh_logits - base_logits)[real].abs().max().item()
    grad_dist = math.sqrt(sum(
        (mesh_grads[k] - base_grads[k]).norm().item() ** 2
        for k in base_grads)) / math.sqrt(sum(
            g.norm().item() ** 2 for g in base_grads.values()))
    same = torch.equal(mesh_logits, base_logits) and all(
        torch.equal(mesh_grads[k], base_grads[k]) for k in base_grads)
    print(f"[vision] (e) bert_base flash, padding mask, {b} x {l}, on a "
          f"world-1 {dist.get_backend()} mesh MeshConfig(model=1, seq=1) "
          f"through Bert.tensor_parallel and split_sequence (column and row "
          f"parallel projections, the gathered mlm_transform, the "
          f"vocab-split embed, attention gathered over seq): real-position "
          f"logits max|mesh - meshless| {logit_diff:.3e} (limit: (d)'s bf16 "
          f"noise {dist_p:.3e}); gradients as one vector "
          f"||mesh - meshless|| / ||meshless|| {grad_dist:.3e} (limit: (d)'s "
          f"xla bf16 distance {whole['xla']:.3e}); bit for bit: {same}; "
          f"launches {launched}")
    if (logit_diff > dist_p or grad_dist > whole["xla"]
            or [launched[k] for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")] != [n, n, n]):
        fail("BERT laid out on a world-1 model and seq mesh differs from "
             "the meshless model")
    dist.destroy_process_group()
    del laid, masters, base_grads, mesh_grads, base_logits, mesh_logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] phase 10 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "bert_padded": rows, "resnet": resnet}


def ring_phase(mods, gpu, dev, fa) -> dict:
    """Phase 11 (a), (b) and (e): the ring's and Ulysses's per-rank bodies
    at llama2_1b's attention width on one card, over virtual chunks, and
    the flash kernels at the ring's chunk shape. Returns the launches of
    the ``ring`` and ``ulysses`` paths and the kernels' rows at the chunk
    shape."""
    from tpu_on_k8s_torch.parallel import ring, ulysses
    from tpu_on_k8s_torch.profile_generate import report
    from tpu_on_k8s_torch.profile_train import group

    paths = {}
    b, h, l, d, n = RING_SHAPE
    lc, hn = l // n, h // n
    gen = torch.Generator(device=dev).manual_seed(RING_SEED)
    q, k, v, do = (torch.randn(b, h, l, d, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    tol_o, tol_lse = TOL[torch.bfloat16]
    tol_g = BWD_REL_TOL[torch.bfloat16]

    def rel_err(a, w):
        return ((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item()

    def row_rel_err(a, w):
        # each output row's largest difference over its largest value: the
        # rows' scales differ by 100x (a causal row 0 is v's row 0, a late
        # row averages thousands), so a merge off by a few percent on some
        # rows shows here and not against one absolute limit; both sides
        # round to bf16 (1 ulp is at most 2^-7 of a value)
        return ((a.float() - w.float()).abs().amax(-1)
                / w.float().abs().amax(-1)).max().item()

    def enqueue_ms(causal):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_ring(causal)
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms

    # ---- (a) the ring's bodies, each fed the chunks it would receive ----
    chunks = [t.chunk(n, dim=2) for t in (q, k, v, do)]

    def run_ring(causal):
        fwd = ring.ring_in_lockstep([ring.ring_forward(
            chunks[0][r], chunks[1][r], chunks[2][r], r, n, causal)
            for r in range(n)])
        bwd = ring.ring_in_lockstep([ring.ring_backward(
            chunks[0][r], chunks[1][r], chunks[2][r], fwd[r][0], fwd[r][1],
            chunks[3][r], r, n, causal) for r in range(n)])
        return fwd, bwd

    def run_whole(causal):
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal)
        return (o, lse), fa.flash_bwd(q, k, v, o, lse, do, causal)

    ring_counts = Counter()
    ring_errs = {}
    for causal in (True, False):
        (o_w, lse_w), grads_w = run_whole(causal)
        torch.cuda.synchronize()
        reset_counts(mods)
        fwd, bwd = run_ring(causal)
        torch.cuda.synchronize()
        got = read_counts(mods)
        ring_counts.update(got)
        runs = n * (n + 1) // 2 if causal else n * n
        o = torch.cat([f[0] for f in fwd], dim=2)
        lse = torch.cat([f[1] for f in fwd], dim=3)
        grads = [torch.cat([g[i] for g in bwd], dim=2) for i in range(3)]
        abs_o = (o.float() - o_w.float()).abs().max().item()
        err_o = row_rel_err(o, o_w)
        err_lse = (lse - lse_w).abs().max().item()
        errs = {name: rel_err(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), grads, grads_w)}
        ring_errs[causal] = dict(o=err_o, lse=err_lse, **errs)
        ring_ms = event_ms(lambda: run_ring(causal), iters=5, reps=5)
        whole_ms = event_ms(lambda: run_whole(causal), iters=5, reps=5)
        host_ms = median(enqueue_ms(causal) for _ in range(5))
        kind = "causal" if causal else "non-causal"
        print(f"[ring] (a) B={b} H={h} L={l} D={d} bf16 {kind} in {n} "
              f"chunks of {lc} (the rotate seam, ranks in lockstep): "
              f"launches flash_fwd {got['flash_fwd']}, dq "
              f"{got['flash_bwd_dq']}, dkv {got['flash_bwd_dkv']} (expected "
              f"{runs} each); against one flash call over {l}: max|o| diff "
              f"{abs_o:.3e}, of its row's largest {err_o:.3e} (tol "
              f"{tol_o:g}), max|lse| diff {err_lse:.3e} (tol {tol_lse:g}), "
              f"dq rel {errs['dq']:.2e}, dk rel {errs['dk']:.2e}, dv rel "
              f"{errs['dv']:.2e} (tol rel {tol_g:g}); {gpu}: ring forward + "
              f"backward {ring_ms:.4f} ms, whole-sequence kernels "
              f"{whole_ms:.4f} ms; the host enqueues the ring in "
              f"{host_ms:.4f} ms (median of 5)")
        try:
            report(f"ring {kind}", lambda: run_ring(causal), 8, group)
        except RuntimeError as e:
            print(f"[ring {kind}] profiler: {e} (not measured)")
        if (got["flash_fwd"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (
                runs, runs, runs):
            fail(f"ring {kind}: launches {got}, expected {runs} of each")
        if err_o > tol_o or err_lse > tol_lse or max(errs.values()) > tol_g:
            fail(f"ring {kind} against the whole-sequence kernels: "
                 f"{ring_errs[causal]}")
        del fwd, bwd, o, lse, grads, o_w, lse_w, grads_w
    paths["ring"] = dict(ring_counts)

    # ---- (b) Ulysses's body over 4 virtual head groups -----------------
    # [B, L, H, D] as the model holds them; rank g's exchanges take the
    # whole sequence of its head group (the all-to-all on one card)
    whole = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out_w = fa.flash_attention(*whole, causal=True)
    grads_w = torch.autograd.grad(out_w, whole, do.transpose(1, 2))
    torch.cuda.synchronize()
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    reset_counts(mods)
    same = True
    for g in range(n):
        heads = slice(g * hn, (g + 1) * hn)
        mine = [t[:, g * lc:(g + 1) * lc] for t in leaves]
        group = {id(c): t[:, :, heads] for c, t in zip(mine, leaves)}
        out = ulysses.ulysses_body(*mine, True, lambda t: group[id(t)],
                                   lambda o: o)
        grads = torch.autograd.grad(out, leaves,
                                    do.transpose(1, 2)[:, :, heads])
        same = same and torch.equal(out, out_w[:, :, heads]) and all(
            torch.equal(gr[:, :, heads], gw[:, :, heads])
            for gr, gw in zip(grads, grads_w))
    torch.cuda.synchronize()
    paths["ulysses"] = got = read_counts(mods)
    print(f"[ulysses] (b) B={b} H={h} L={l} D={d} bf16 causal, {n} virtual "
          f"head groups of {hn}: each group's output and dq/dk/dv equal the "
          f"whole-head call's heads bit for bit: {same}; launches flash_fwd "
          f"{got['flash_fwd']}, dq {got['flash_bwd_dq']}, dkv "
          f"{got['flash_bwd_dkv']} (expected {n} each)")
    if not same or (got["flash_fwd"], got["flash_bwd_dq"],
                    got["flash_bwd_dkv"]) != (n, n, n):
        fail(f"Ulysses's head groups: bit for bit {same}, launches {got}")
    del whole, out_w, grads_w, leaves, out, grads

    # ---- (e) the kernels at the ring's chunk shape, non-causal ---------
    qc, kc, vc, dc = (t[:, :, :lc].contiguous() for t in (q, k, v, do))
    o, lse = fa.flash_with_lse_fwd(qc, kc, vc, False)
    po, _ = fa.flash_attention_plain(qc, kc, vc, False)
    delta = (dc.float() * o.float()).sum(-1)[:, :, None, :]
    dq = fa.flash_bwd_dq(qc, kc, vc, dc, lse, delta, False)
    dk, dv = fa.flash_bwd_dkv(qc, kc, vc, dc, lse, delta, False)
    pdq = fa.flash_bwd_dq_plain(qc, kc, vc, dc, lse, delta, False)
    pdk, pdv = fa.flash_bwd_dkv_plain(qc, kc, vc, dc, lse, delta, False)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn, stream = sdpa_backward(qc, kc, vc, dc)
    sdpa_bwd = time_ms(fn, stream=stream)
    shape = (f"B={b} H={h} L={lc} D={d} bf16 non-causal (the ring's "
             f"{n}-way chunk of {l})")
    rows = {
        "flash_fwd": dict(
            ms=time_ms(lambda: fa.flash_with_lse_fwd(qc, kc, vc, False)),
            plain_ms=plain_time_ms(lambda: fa.flash_attention_plain(
                qc, kc, vc, False)),
            library_ms=time_ms(lambda: sdpa(qc, kc, vc)),
            max_abs_err=(o.float() - po.float()).abs().max().item(),
            **dict(zip(("bound_ms", "bound_by"),
                       flash_bound_ms(b, h, h, lc, d, False)))),
        "flash_bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq(qc, kc, vc, dc, lse, delta,
                                               False)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dq_plain(
                qc, kc, vc, dc, lse, delta, False)),
            library_ms=sdpa_bwd,
            max_abs_err=(dq.float() - pdq.float()).abs().max().item(),
            **dict(zip(("bound_ms", "bound_by"),
                       dq_bound_ms(b, h, h, lc, d, False)))),
        "flash_bwd_dkv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkv(qc, kc, vc, dc, lse, delta,
                                                False)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dkv_plain(
                qc, kc, vc, dc, lse, delta, False)),
            library_ms=sdpa_bwd,
            max_abs_err=max((dk.float() - pdk.float()).abs().max().item(),
                            (dv.float() - pdv.float()).abs().max().item()),
            **dict(zip(("bound_ms", "bound_by"),
                       dkv_bound_ms(b, h, h, lc, d, False)))),
    }
    errs = {"flash_fwd": row_rel_err(o, po) > tol_o,
            "flash_bwd_dq": rel_err(dq, pdq) > tol_g,
            "flash_bwd_dkv": max(rel_err(dk, pdk), rel_err(dv, pdv)) > tol_g}
    for name, r in rows.items():
        r["shape"] = shape
        print(f"[time] {gpu}: {name} {shape}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa non-causal "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
              f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound; "
              f"max|kernel - plain| {r['max_abs_err']:.3e}")
    print(f"[time] {gpu}: flash_fwd {shape}: max|kernel - plain| of its "
          f"row's largest {row_rel_err(o, po):.3e} (tol {tol_o:g})")
    if any(errs.values()):
        fail(f"the flash kernels at the ring's chunk shape against their "
             f"plain twins: {errs}")
    del q, k, v, do, qc, kc, vc, dc, o, lse, po, dq, dk, dv, pdq, pdk, pdv
    torch.cuda.empty_cache()
    return {"paths": paths, "rows": rows}


def pipeline_phase(tcfg, mods, gpu, dev, stage_mesh, gpipe) -> dict:
    """Phase 11 (d): ``gpipe`` over ``stage_mesh(1, 1)`` with llama2_1b's
    16 blocks (flash, bf16 compute on fp32 masters) stacked and run
    through ``torch.func.functional_call``, 2 x 2048 in 2 microbatches,
    against the same blocks run in turn in bf16 and in fp32. Returns the
    ``pipeline`` path's launches."""
    from torch.func import functional_call

    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.transformer import (
        Block,
        Positions,
        _rope_tables,
    )

    rows, seq, n_micro = PIPE_SHAPE
    p0 = init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=tcfg.param_dtype)
    names = sorted({k.split(".", 2)[2] for k in p0 if k.startswith("blocks.")})
    stacked = {name: torch.stack([p0[f"blocks.{i}.{name}"]
                                  for i in range(tcfg.n_layers)])
               for name in names}
    del p0
    gen = torch.Generator(device=dev).manual_seed(PIPE_SEED)
    x = torch.randn(rows, seq, tcfg.d_model, generator=gen, device=dev)
    weight = torch.randn(rows, seq, tcfg.d_model, generator=gen, device=dev)

    def run(cfg, pipelined):
        with torch.device("meta"):
            block = Block(cfg)
        pos = {}
        for r in (rows, rows // n_micro):
            ids = torch.arange(seq, dtype=torch.int32, device=dev).expand(
                r, -1)
            cos, sin = _rope_tables(ids, cfg.head_dim // 2, cfg.rope_theta)
            pos[r] = Positions(ids, cos[:, :, None, :], sin[:, :, None, :],
                               False)

        def layer_fn(p, h):
            return functional_call(block, p, (h, pos[h.shape[0]]))

        leaves = {k: t.detach().requires_grad_() for k, t in stacked.items()}
        h0 = x.detach().to(cfg.dtype).requires_grad_()
        if pipelined:
            out = gpipe(layer_fn, leaves, h0, mesh=stage_mesh(1, 1,
                                                             device=dev),
                        n_micro=n_micro)
        else:
            out = h0
            for i in range(cfg.n_layers):
                out = layer_fn({k: t[i] for k, t in leaves.items()}, out)
        grads = torch.autograd.grad((out.float() * weight).sum(),
                                    [h0, *leaves.values()])
        return out.detach().float(), dict(zip(["x", *leaves], grads))

    bcfg = dataclasses.replace(tcfg, remat=False, attn_impl="flash")
    reset_counts(mods)
    out_p, g_p = run(bcfg, True)
    torch.cuda.synchronize()
    got = read_counts(mods)
    out_s, g_s = run(bcfg, False)
    out_32, g_32 = run(dataclasses.replace(bcfg, dtype=torch.float32), False)
    torch.cuda.synchronize()
    err = ((out_p - out_s).abs().max() / out_s.abs().max()).item()

    def rel_dist(g, ref):
        return {n: ((g[n].float() - ref[n].float()).norm()
                    / ref[n].float().norm()).item() for n in ref}

    dist_p, dist_s = rel_dist(g_p, g_32), rel_dist(g_s, g_32)
    ratios = {n: dist_p[n] / dist_s[n] if dist_s[n] else 1.0 for n in dist_p}
    worst = max(ratios, key=ratios.get)
    want = tcfg.n_layers * n_micro
    print(f"[pipeline] (d) gpipe over stage_mesh(1, 1), {tcfg.n_layers} "
          f"llama2_1b blocks (flash) stacked through functional_call, "
          f"{rows} x {seq} in {n_micro} microbatches: max|pipelined - "
          f"sequential| / max|sequential| {err:.3e} (tol "
          f"{TOL[torch.bfloat16][0]:g}); gradients (x and {len(names)} "
          f"stacked leaves) ||g - g_fp32|| / ||g_fp32|| pipelined max "
          f"{max(dist_p.values()):.4e}, sequential bf16 max "
          f"{max(dist_s.values()):.4e}, ratio max {ratios[worst]:.3f} at "
          f"{worst} (limit {GRAD_NOISE_MULT:g}); launches flash_fwd "
          f"{got['flash_fwd']}, dq {got['flash_bwd_dq']}, dkv "
          f"{got['flash_bwd_dkv']} (expected {want} each)")
    if err > TOL[torch.bfloat16][0] or ratios[worst] > GRAD_NOISE_MULT:
        fail(f"gpipe against the sequential blocks: output {err}, gradient "
             f"ratios {ratios}")
    if (got["flash_fwd"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (
            want, want, want):
        fail(f"gpipe launches {got}, expected {want} of each")
    del stacked, out_p, out_s, out_32, g_p, g_s, g_32
    torch.cuda.empty_cache()
    return got


def seq_phase(tcfg, mods, gpu, dev, tokens, fa) -> dict:
    """Phase 11: sequence and pipeline parallelism (see the module
    docstring). Returns the launches of its paths and the flash kernels'
    rows at the ring's chunk shape."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import (
        MeshConfig,
        create_mesh,
        mesh_shape,
    )
    from tpu_on_k8s_torch.parallel.pipeline import gpipe, stage_mesh
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train.distributed import initialize

    t_phase = time.perf_counter()
    ring = ring_phase(mods, gpu, dev, fa)
    paths = ring["paths"]

    # ---- (c) the model on a seq axis of 1 ------------------------------
    initialize({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(free_port())}, device=dev)
    mesh = create_mesh(MeshConfig(seq=1), device=dev)
    opt_kw = dict(warmup_steps=10, decay_steps=max(TRAIN_STEPS, 11))

    def two_steps(attn):
        cfg = dataclasses.replace(tcfg, attn_impl=attn)
        model = load_model(cfg, init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev,
            dtype=cfg.param_dtype), dev)
        trainer = Trainer(model, default_optimizer(model.parameters(),
                                                   **opt_kw),
                          rules=flagship_partition_rules(), mesh=mesh)
        batch = trainer.shard_batch(tokens)
        out = []
        for _ in range(SEQ_STEPS):
            m = trainer.train_step(batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        del trainer, model
        gc.collect()    # FSDP2's hooks hold cycles
        torch.cuda.empty_cache()
        return out

    reset_counts(mods)
    runs = {attn: two_steps(attn) for attn in ("xla", "ring", "ulysses",
                                               "flash")}
    torch.cuda.synchronize()
    paths["seq_model"] = got = read_counts(mods)
    want = SEQ_STEPS * tcfg.n_layers
    equal = {attn: runs[attn] == runs["xla"] for attn in ("ring", "ulysses")}
    print(f"[seq] (c) llama2_1b on a world-1 {dist.get_backend()} mesh "
          f"{mesh_shape(mesh)}, {SEQ_STEPS} steps on phase 4's batch "
          f"({TRAIN_BATCH} x {TRAIN_SEQ}), (loss, grad norm): "
          + "; ".join(f"{attn} {[(round(a, 5), round(g, 5)) for a, g in r]}"
                      for attn, r in runs.items())
          + f"; ring and ulysses (a ring of one: the plain attention) equal "
          f"xla bit for bit: {equal}; flash launches flash_fwd "
          f"{got['flash_fwd']}, dq {got['flash_bwd_dq']}, dkv "
          f"{got['flash_bwd_dkv']} (expected {want} each)")
    if not all(equal.values()) or not all(
            math.isfinite(a) for a, _ in runs["flash"]):
        fail(f"the seq-axis model runs: {runs}")
    if (got["flash_fwd"], got["flash_bwd_dq"], got["flash_bwd_dkv"]) != (
            want, want, want):
        fail(f"the seq mesh's flash launches {got}, expected {want}")

    # ---- (d) GPipe over a stage axis of 1 ------------------------------
    paths["pipeline"] = pipeline_phase(tcfg, mods, gpu, dev, stage_mesh,
                                       gpipe)
    dist.destroy_process_group()

    # ---- (c) the CLI on the card, in the process (a process of its own
    # took ~19 s, most of it starting; cut to make room for phase 19) ----
    import contextlib
    import io

    from tpu_on_k8s_torch import train_llama

    t0 = time.perf_counter()
    argv = ["--config", "tiny", "--attn", "ring", "--seq-axis", "1",
            "--steps", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = train_llama.main(argv)
    metric_lines = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("[elastic-metrics]")]
    print(f"[seq] (c) train_llama.main({' '.join(argv)}) in the process: "
          f"final loss {loss:.5f} in {time.perf_counter() - t0:.1f} s; "
          f"{len(metric_lines)} metric lines, the last: "
          f"{metric_lines[-1] if metric_lines else None}; no world left "
          f"{not dist.is_initialized()}")
    if (len(metric_lines) != 3 or not math.isfinite(loss)
            or dist.is_initialized()):
        fail("train_llama --attn ring did not finish")
    print(f"[time] phase 11 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "ring_chunk": ring["rows"]}


def moe_routing_recorder(moe, store: list):
    """Patch ``moe.route`` so that each call also records its tokens' top-k
    experts ``[B, L, k]`` in ``store``."""
    route = moe.route

    def recording(x, router, k, cap, seq=None):
        out = route(x, router, k, cap, seq)
        store.append(out.probs.topk(k, dim=-1).indices)
        return out

    return mock.patch.object(moe, "route", recording)


def moe_teacher_forced(models, reqs, tokens, plain_flash, transformer,
                       decode, moe, dev) -> dict:
    """For each request: its prompt padded to the engine's bucket through
    the kernel model and through the plain attention (their last-position
    logits and routing), then the emitted tokens after it over the plain
    prefill's cache at a capacity that drops nothing. Returns the gaps
    (max logit - logit[emitted]) per request, max|kernel - plain| of the
    last-position logits and the share of agreeing routing decisions."""
    model, nodrop = models
    gaps, diff, same, total = [], 0.0, 0, 0
    with torch.inference_mode():
        for j, (p, _) in enumerate(reqs):
            n, emitted = p.size, tokens[j]
            bucket = decode._bucket_len(n, ENGINE_MAX_LEN)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = p
            prompt = torch.from_numpy(padded).to(dev)
            at = torch.tensor([n - 1], device=dev)
            length = decode._bucket_len(max(bucket, n + emitted.size),
                                        ENGINE_MAX_LEN)
            routes = {}
            for kind in ("kernel", "plain"):
                routes[kind] = []
                cache = decode.init_cache(model, 1, length)
                patch = (mock.patch.object(transformer, "flash_attention",
                                           plain_flash)
                         if kind == "plain" else nullcontext())
                with patch, moe_routing_recorder(moe, routes[kind]):
                    last = model(prompt, None, cache, at=at)[0, 0]
                if kind == "kernel":
                    last_k = last
            diff = max(diff, (last_k - last).abs().max().item())
            for rk, rp in zip(routes["kernel"], routes["plain"]):
                same += int((rk[:, :n] == rp[:, :n]).sum())
                total += rk[:, :n].numel()
            decode._set_cursor(cache, n)
            rest = torch.from_numpy(emitted[:-1].astype(np.int32))[None]
            pos = torch.arange(n, n + rest.shape[1], dtype=torch.int32)[None]
            with mock.patch.object(transformer, "flash_attention",
                                   plain_flash):
                later = (nodrop(rest.to(dev), pos.to(dev), cache)[0]
                         if rest.shape[1] else last[None][:0])
            rows = torch.cat([last[None], later])
            want = torch.from_numpy(emitted).to(dev, torch.long)
            gaps.append(rows.max(dim=-1).values
                        - rows.gather(1, want[:, None])[:, 0])
    return {"gaps": gaps, "diff": diff, "agree": same / total,
            "decisions": total}


def moe_phase(tokens, mods, gpu, dev, fa) -> dict:
    """Phase 12: MoE at llama2_1b width with Mixtral-8x7B's routing (see the
    module docstring). Returns the launches of its paths and the int8
    kernel's row at one expert's product."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models import decode, moe, serving, transformer
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.parallel.mesh import (
        MeshConfig,
        create_mesh,
        serving_mesh,
    )
    from tpu_on_k8s_torch.parallel.serving import shutdown_mesh_workers
    from tpu_on_k8s_torch.profile_generate import report
    from tpu_on_k8s_torch.profile_train import group
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import trainer as trainer_mod
    from tpu_on_k8s_torch.train.distributed import initialize

    i8 = mods["i8"]
    t_phase = time.perf_counter()
    paths = {}
    cfg = dataclasses.replace(transformer.TransformerConfig.llama2_1b(),
                              n_experts=MOE_EXPERTS, experts_top_k=MOE_TOP_K)
    e, k = cfg.n_experts, cfg.experts_top_k

    def plain_flash(q, k_, v, causal=True, segments=None):
        o, _ = fa.flash_attention_plain(q.transpose(1, 2), k_.transpose(1, 2),
                                        v.transpose(1, 2), causal, 0, segments)
        return o.transpose(1, 2)

    # ---- (a) the engine --------------------------------------------------
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MOE_SEED), dev)
    reqs = engine_traffic(cfg.vocab_size)[0][:MOE_REQUESTS]
    shape = dict(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                 clock=time.monotonic, device=dev)
    n_params = sum(t.numel() for t in params.values())
    print(f"[moe] llama2_1b width, {cfg.n_layers} layers, {e} experts top "
          f"{k} (capacity factor {cfg.expert_capacity_factor}), "
          f"{n_params:,} params bf16 (router fp32); {len(reqs)} of phase "
          f"3e's requests on {ENGINE_SLOTS} slots x {ENGINE_MAX_LEN}")
    engine = serving.ContinuousBatchingEngine(cfg, params, **shape)
    reset_counts(mods)
    run = drive_engine(engine, reqs, None, set(), mods, time.monotonic)
    paths["moe_serve"] = run["launched"]
    # where a decode step's time goes: 4 steps with every slot busy
    for p, _ in reqs[:ENGINE_SLOTS]:
        engine.submit(p, 64)
    while engine.free_slots:
        engine.step()
    report("moe decode x4", lambda: [engine.step() for _ in range(4)], 8,
           group, host_top=6)
    del engine
    orig_route = moe.route

    def second_dropped(x, router, k_, cap, seq=None):
        return orig_route(x, router, 1, cap, seq)

    control_engine = serving.ContinuousBatchingEngine(cfg, params, **shape)
    with mock.patch.object(moe, "route", second_dropped):
        control = drive_engine(control_engine, reqs, None, set(), mods,
                               time.monotonic)
    del control_engine
    gc.collect()
    tf_cfg = dataclasses.replace(cfg, max_seq_len=ENGINE_MAX_LEN)
    models = (decode.decode_model(tf_cfg, params, dev),
              decode.decode_model(dataclasses.replace(
                  tf_cfg, expert_capacity_factor=e / k), params, dev))
    sound = moe_teacher_forced(models, reqs, run["tokens"], plain_flash,
                               transformer, decode, moe, dev)
    fault = moe_teacher_forced(models, reqs, control["tokens"], plain_flash,
                               transformer, decode, moe, dev)
    tau = MOE_TAU_MULT * sound["diff"]
    steps = run["step_ms"]
    print(f"[moe] (a) engine: {run['emitted']} tokens in {run['wall']:.2f} "
          f"s, {run['fresh']} fresh prefills, launches {run['launched']}; "
          f"decode step (all slots busy) median "
          f"{statistics.median(steps) if steps else float('nan'):.2f} ms "
          f"over {len(steps)} steps; routing decisions (layer, prompt "
          f"token, round) on which the kernel and plain-attention prefills "
          f"agree: {sound['agree']:.5f} of {sound['decisions']}; max|kernel "
          f"- plain| last-position prefill logits {sound['diff']:.4f}")
    tau_gate("[moe] (a) engine", sound["gaps"], tau, sound["diff"],
             mult=MOE_TAU_MULT, exact_min=MOE_EXACT_MIN, unit="phase 12's")
    tau_gate("[moe] (a) control (second expert dropped)", fault["gaps"], tau,
             sound["diff"], control=True, every=False, mult=MOE_TAU_MULT,
             exact_min=MOE_EXACT_MIN, unit="phase 12's")
    exact = (torch.cat(fault["gaps"]) == 0).float().mean().item()
    caught = sum(int(g.max() > tau) for g in fault["gaps"])
    if exact >= MOE_EXACT_MIN or caught < MOE_CONTROL_SHARE * len(reqs):
        fail(f"[moe] (a) the control broke the gate's limits too weakly: "
             f"exact share {exact:.4f} (must be below {MOE_EXACT_MIN}), "
             f"{caught} of {len(reqs)} requests above tau (at least "
             f"{MOE_CONTROL_SHARE:g} of them)")
    del models
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the serving mesh of one rank --------------------------------
    initialize({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(free_port())}, device=dev)
    few = reqs[:MOE_MESH_REQUESTS]
    outs = {}
    for kind, mesh in (("meshless", None),
                       ("serving_mesh(1, 1, 1)", serving_mesh(1, 1, 1,
                                                              device=dev))):
        engine = serving.ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                                  **shape)
        reset_counts(mods)
        outs[kind] = drive_engine(engine, few, None, set(), mods,
                                  time.monotonic)
        if mesh is not None:
            paths["moe_serve_mesh"] = outs[kind]["launched"]
        engine.close()
        del engine
        gc.collect()
    shutdown_mesh_workers()
    equal = all(np.array_equal(outs["meshless"]["tokens"][j], t)
                for j, t in outs["serving_mesh(1, 1, 1)"]["tokens"].items())
    print(f"[moe] (d) engine on serving_mesh(1, 1, 1) ({dist.get_backend()})"
          f", {len(few)} requests: tokens equal the meshless engine's: "
          f"{equal}")
    if not equal:
        fail("the MoE engine on a serving mesh of one rank differs from "
             "the meshless engine")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) training -----------------------------------------------------
    tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS, remat=True,
                               remat_policy="mlp", attn_impl="flash")
    tparams = init_params(tcfg, torch.Generator(device=dev).manual_seed(
        MOE_SEED), dev, dtype=tcfg.param_dtype)

    def pinned_routing(model, masks: dict, record: bool):
        """Patch ``moe.route`` for ``model``: with ``record`` each layer's
        dispatch mask goes into ``masks`` (the first call's; a checkpoint's
        recompute routes alike); else each layer dispatches as ``masks``
        holds, its probabilities and gates from its own router, as
        ``moe.route`` computes them (a chosen expert's gate is its
        probability)."""
        layer_of = {blk.moe.router.data_ptr(): i
                    for i, blk in enumerate(model.blocks)}
        route = moe.route

        def pinned(x, router, k_, cap, seq=None):
            i = layer_of[router.data_ptr()]
            if record:
                out = route(x, router, k_, cap, seq)
                masks.setdefault(i, out.dispatch.bool())
                return out
            mask = masks[i]
            probs = torch.softmax(torch.matmul(x.float(), router.float()),
                                  dim=-1)
            return moe.Routing(probs, mask.to(x.dtype),
                               mask.float() * probs[..., None])

        return mock.patch.object(moe, "route", pinned)

    def first_grads(model_cfg, plain, masks, record=False):
        model = load_model(model_cfg, tparams, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None, MOE_AUX)
        attn = (mock.patch.object(transformer, "flash_attention_bhld",
                                  lambda q, k_, v, causal=True, valid_len=0,
                                  segments=None: fa.flash_attention_plain(
                                      q, k_, v, causal, valid_len,
                                      segments)[0])
                if plain else nullcontext())
        # the int8 products' plain twin in place of the kernel
        gemm = (mock.patch.object(i8, "_kernel_op", i8.int8_matmul_plain)
                if plain else nullcontext())
        with attn, gemm, pinned_routing(model, masks, record):
            loss, (aux, _) = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        out = loss.item(), aux.item(), dict(zip(names, grads))
        del model, loss, aux, grads
        return out

    def rel_dist(g, ref):
        return {n: ((g[n].float() - ref[n]).norm() / ref[n].norm()).item()
                for n in ref}

    def gradient_gate(tag: str, gcfg) -> None:
        """Phase 4's noise-floor rule on ``gcfg``'s first-step gradients,
        the routing pinned to the fp32 plain model's."""
        masks = {}
        loss_32, aux_32, grads_32 = first_grads(
            dataclasses.replace(gcfg, dtype=torch.float32), True, masks,
            record=True)
        loss_k, aux_k, grads_k = first_grads(gcfg, False, masks)
        loss_p, aux_p, grads_p = first_grads(gcfg, True, masks)
        del masks
        dist_k = rel_dist(grads_k, grads_32)
        dist_p = rel_dist(grads_p, grads_32)
        ratios = sorted(dist_k[n] / dist_p[n] for n in dist_k)
        print(f"[moe] (b) gradient gate{tag}, step 1, {MOE_TRAIN_LAYERS} "
              f"layers, {len(dist_k)} tensors, routing pinned to the fp32 "
              f"plain model's, ||g - g_fp32|| / ||g_fp32||: kernel bf16 max "
              f"{max(dist_k.values()):.4e} (at "
              f"{max(dist_k, key=dist_k.get)}), median "
              f"{statistics.median(dist_k.values()):.4e}; plain bf16 max "
              f"{max(dist_p.values()):.4e}, median "
              f"{statistics.median(dist_p.values()):.4e}; per-tensor ratio "
              f"kernel/plain median {statistics.median(ratios):.3f}, max "
              f"{ratios[-1]:.3f} (limit {GRAD_NOISE_MULT:g}); loss kernel "
              f"{loss_k:.6f} plain {loss_p:.6f} fp32 {loss_32:.6f}; aux "
              f"kernel {aux_k:.6f} plain {aux_p:.6f} fp32 {aux_32:.6f}")
        for name in ("blocks.0.moe.router", "blocks.0.moe.w_gate",
                     f"blocks.{MOE_TRAIN_LAYERS - 1}.moe.w_down",
                     "blocks.0.attn.wq.weight", "lm_head"):
            print(f"[moe]   {name}: kernel {dist_k[name]:.4e} plain "
                  f"{dist_p[name]:.4e}")
        if not all(torch.isfinite(g).all() for g in grads_k.values()) or not (
                math.isfinite(aux_k) and aux_k > 0):
            fail(f"the MoE model's gradients or aux loss{tag} are not "
                 f"finite")
        if ratios[-1] > GRAD_NOISE_MULT:
            fail(f"the MoE kernel model's gradients{tag} stray further from "
                 f"the fp32 model's than bf16 rounding explains")
        del grads_k, grads_p, grads_32
        gc.collect()
        torch.cuda.empty_cache()

    gcfg = dataclasses.replace(tcfg, remat_policy="full")
    gradient_gate("", gcfg)
    gradient_gate(" under mlp_int8 (pallas; plain side the int8 GEMM's "
                  "plain twin)", dataclasses.replace(
                      gcfg, mlp_int8=True, int8_impl="pallas"))

    opt_kw = dict(warmup_steps=10, decay_steps=11)

    def one_step(model_cfg, mesh=None, split=False):
        model = load_model(model_cfg, {n: t.clone() for n, t in
                                       tparams.items()}, dev)
        if split:
            # the seq axis's code paths, which shard_model runs only over
            # an axis > 1: the seq-aware route, attention gathered over it
            model.split_sequence(mesh)
        trainer = Trainer(model, default_optimizer(model.parameters(),
                                                   **opt_kw),
                          rules=(None if mesh is None else
                                 transformer.flagship_partition_rules()),
                          mesh=mesh, aux_loss_weight=MOE_AUX)
        reset_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(trainer.shard_batch(tokens))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = read_counts(mods)
        weights = {n: (p.full_tensor() if mesh is not None else p).detach()
                   for n, p in trainer.model.named_parameters()}
        out = ({key: float(m[key]) for key in ("loss", "aux_loss",
                                              "grad_norm")},
               launched, ms, weights)
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    base, launched, ms, base_w = one_step(tcfg)
    paths["moe_train"] = launched
    n = tcfg.n_layers
    print(f"[moe] (b) one step, remat mlp, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: {base}, {ms:.1f} ms (the first, host clock); "
          f"launches {launched} (expected {n} of each flash kernel)")
    if (launched["flash_fwd"], launched["flash_bwd_dq"],
            launched["flash_bwd_dkv"], launched["int8_matmul"]) != (
                n, n, n, 0) or not all(map(math.isfinite, base.values())):
        fail(f"the MoE step: {base}, launches {launched}")
    i8cfg = dataclasses.replace(tcfg, mlp_int8=True, int8_impl="pallas")
    q8, launched8, ms8, _ = one_step(i8cfg)
    paths["moe_train_int8"] = launched8
    # each expert's gate, up and down products, in the forward and again
    # in the MoE's checkpoint
    want8 = n * 3 * e * 2
    print(f"[moe] (b) one step under mlp_int8 (pallas): {q8}, {ms8:.1f} ms; "
          f"int8_matmul launches {launched8['int8_matmul']} (expected "
          f"{want8} = {n} layers x 3 products x {e} experts x 2)")
    if launched8["int8_matmul"] != want8 or not math.isfinite(q8["loss"]):
        fail(f"the MoE int8 step: {q8}, launches {launched8}")

    # ---- (d) the training mesh of one rank --------------------------------
    mesh = create_mesh(MeshConfig(expert=1), device=dev)
    meshed, launched_m, _, mesh_w = one_step(tcfg, mesh)
    paths["moe_train_mesh"] = launched_m
    same_w = all(torch.equal(mesh_w[name], w) for name, w in base_w.items())
    print(f"[moe] (d) one step on MeshConfig(expert=1): {meshed}; equal to "
          f"the meshless step: metrics {meshed == base}, weights {same_w}")
    if meshed != base or not same_w:
        fail("the MoE step on a mesh of one rank differs from the meshless "
             "step")
    # ---- (e) a seq axis of one rank: the seq-aware route -----------------
    seq_mesh = create_mesh(MeshConfig(seq=1), device=dev)
    seqd, launched_s, _, seq_w = one_step(tcfg, seq_mesh, split=True)
    paths["moe_train_seq"] = launched_s
    same_s = all(torch.equal(seq_w[name], w) for name, w in base_w.items())
    print(f"[moe] (e) one step on MeshConfig(seq=1) through "
          f"Transformer.split_sequence (the seq-aware route, its slot "
          f"counts all-gathered over seq each round; attention gathered "
          f"over seq): {seqd}; equal to the meshless step bit for bit: "
          f"metrics {seqd == base}, weights {same_s}; launches {launched_s}")
    if seqd != base or not same_s:
        fail("the MoE step on a seq axis of one rank differs from the "
             "meshless step")
    dist.destroy_process_group()
    del tparams, base_w, mesh_w
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the int8 kernel at one expert's product ----------------------
    cap = moe.capacity(tcfg, TRAIN_SEQ)
    m_rows, n_cols, k_in = TRAIN_BATCH * cap, cfg.d_ff, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    xq, sx = i8._quant_rows(torch.randn(m_rows, k_in, generator=gen,
                                        device=dev).to(torch.bfloat16))
    wq, sw = i8._quant_rows((0.02 * torch.randn(n_cols, k_in, generator=gen,
                                                device=dev)).to(torch.bfloat16))
    out = i8.int8_matmul_kernel(xq, sx, wq, sw, torch.bfloat16)
    want = i8.int8_matmul_plain(xq, sx, wq, sw, torch.bfloat16)
    err = (out.float() - want.float()).abs().max().item()
    kernel_ms = time_ms(lambda: i8.int8_matmul_kernel(xq, sx, wq, sw,
                                                      torch.bfloat16))
    plain_ms = event_ms(lambda: i8.int8_matmul_plain(xq, sx, wq, sw,
                                                     torch.bfloat16))
    lib_ms = time_ms(lambda: i8._int_mm(xq, sx, wq, sw, torch.bfloat16))
    bound, by = int8_bound_ms(m_rows, n_cols, k_in, torch.bfloat16)
    print(f"[moe] (c) {gpu}: int8_matmul at one expert's product M={m_rows} "
          f"({TRAIN_BATCH} x capacity {cap}) N={n_cols} K={k_in} bf16 out: "
          f"max|kernel - plain| {err} (bit for bit: {torch.equal(out, want)})"
          f"; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch._int_mm + epilogue {lib_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}), {bound / kernel_ms:.1%} of bound")
    if not torch.equal(out, want):
        fail("the int8 kernel differs from its plain twin at the expert's "
             "shape")
    print(f"[time] phase 12 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "expert_row": {
        "shape": f"M={m_rows} N={n_cols} K={k_in} bf16 out",
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "library_ms": lib_ms, "max_abs_err": err}}


def head_dim_256_phase(mods, gpu, dev, fa, transformer, decode,
                        trainer_mod, init_params, load_model) -> dict:
    """Phase 5b: head dim 256. (a) the three kernels at google/gemma-7b's
    attention width (``D_256_SHAPE``) against their plain twins and timed
    beside them, SDPA (the forward; the backward through autograd in a
    graph) and their bound (the JSON's ``d256``); (b) a model of head dim
    256 (``D_256_LAYERS`` layers of d_model 4096 over 16 heads): generate,
    its flash forward launched once a layer per prefill, its prefill logits
    held by phase 3's noise-floor rule; (c) one forward and backward by
    phase 4's gradient gate, each kernel launched once a layer. Returns the
    launches of its paths and the kernels' rows."""
    t_phase = time.perf_counter()
    b, h, l, d, causal = D_256_SHAPE
    gen = torch.Generator(device=dev).manual_seed(D_256_SEED)
    q, k, v, do = (torch.randn(b, h, l, d, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_with_lse_fwd(q, k, v, causal)
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    grads = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    plain = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
             *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[torch.bfloat16]
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    errs = [(a.float() - w.float()).abs().max().item()
            for a, w in zip(grads, plain)]
    rels = [e / w.float().abs().max().item() for e, w in zip(errs, plain)]
    shape = (f"B={b} H={h} L={l} D={d} bf16 "
             f"{'causal' if causal else 'non-causal'} (gemma-7b's heads)")
    print(f"[d256] (a) {shape}: max|o-plain| {err_o:.3e} (tol {tol_o:g}) "
          f"max|lse-plain| {err_lse:.3e} (tol {tol_lse:g}); rel dq "
          f"{rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tol rel "
          f"{BWD_REL_TOL[torch.bfloat16]:g})")
    if (err_o > tol_o or err_lse > tol_lse
            or max(rels) > BWD_REL_TOL[torch.bfloat16]):
        fail(f"the D 256 kernels disagree with their plain twins: {shape}")
    del po, plse, plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn, stream = sdpa_backward(q, k, v, do, is_causal=causal)
    sdpa_bwd = time_ms(fn, stream=stream)
    rows = {
        "flash_fwd": dict(
            ms=time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, causal)),
            plain_ms=plain_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal)),
            library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=causal)),
            max_abs_err=err_o,
            **dict(zip(("bound_ms", "bound_by"),
                       flash_bound_ms(b, h, h, l, d, causal)))),
        "flash_bwd_dq": dict(
            ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                               causal)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dq_plain(
                q, k, v, do, lse, delta, causal)),
            library_ms=sdpa_bwd, max_abs_err=errs[0],
            **dict(zip(("bound_ms", "bound_by"),
                       dq_bound_ms(b, h, h, l, d, causal)))),
        "flash_bwd_dkv": dict(
            ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                causal)),
            plain_ms=plain_time_ms(lambda: fa.flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, causal)),
            library_ms=sdpa_bwd, max_abs_err=max(errs[1:]),
            **dict(zip(("bound_ms", "bound_by"),
                       dkv_bound_ms(b, h, h, l, d, causal)))),
    }
    for name, r in rows.items():
        r["shape"] = shape
        print(f"[time] {gpu}: {name} {shape}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, sdpa "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
              f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound, "
              f"{r['library_ms'] / r['ms']:.2f} x sdpa's speed")
    del q, k, v, do, o, lse, delta, grads, fn
    torch.cuda.empty_cache()

    # ---- (b) a model at head dim 256: generate ---------------------------
    paths = {}
    cfg = dataclasses.replace(transformer.TransformerConfig.llama2_7b(),
                              n_layers=D_256_LAYERS, n_heads=16,
                              n_kv_heads=16)
    n = cfg.n_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        D_256_SEED), dev)
    prompt = torch.randint(0, cfg.vocab_size, D_256_PROMPT, generator=gen,
                           device=dev, dtype=torch.int32)
    reset_counts(mods)
    tokens = decode.generate(cfg, params, prompt, D_256_NEW)
    torch.cuda.synchronize()
    paths["d256_generate"] = launched = read_counts(mods)
    print(f"[d256] (b) {n} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} head_dim {cfg.head_dim}: "
          f"generate {tuple(prompt.shape)} -> {D_256_NEW} tokens, row 0 "
          f"{tokens[0, :8].tolist()} ...; launches {launched}")
    if (launched["flash_fwd"], launched["flash_bwd_dq"],
            launched["flash_bwd_dkv"]) != (n, 0, 0) or tuple(
                tokens.shape) != (D_256_PROMPT[0], D_256_NEW) or int(
                    tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size:
        fail(f"generate at head dim 256: tokens {tuple(tokens.shape)}, "
             f"launches {launched}; expected {n} flash_fwd")

    def plain_flash(q, k, v, causal=True, segments=None):
        o, _ = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal, 0, segments)
        return o.transpose(1, 2)

    def prefill_logits(model_cfg, model_params):
        model = decode.decode_model(model_cfg, model_params, dev)
        with torch.inference_mode():
            return model(prompt, None, decode.init_cache(
                model, D_256_PROMPT[0]))

    logits_kernel = prefill_logits(cfg, params)
    with mock.patch.object(transformer, "flash_attention", plain_flash):
        logits_plain = prefill_logits(cfg, params)
        logits_f32 = prefill_logits(
            dataclasses.replace(cfg, dtype=torch.float32),
            {name: p.float() for name, p in params.items()})
    noise = (logits_plain - logits_f32).abs().max().item()
    kernel_noise = (logits_kernel - logits_f32).abs().max().item()
    print(f"[d256] (b) prefill logits: max|kernel bf16 - fp32 model| "
          f"{kernel_noise:.3e} (tol {LOGITS_NOISE_MULT:g} x max|plain bf16 "
          f"- fp32 model| {noise:.3e})")
    if not bool(torch.isfinite(logits_kernel).all()) or (
            kernel_noise > LOGITS_NOISE_MULT * noise):
        fail("the head-dim-256 prefill logits stray further from the fp32 "
             "model than bf16 rounding explains")
    del logits_kernel, logits_plain, logits_f32
    torch.cuda.empty_cache()

    # ---- (c) one forward and backward: the gradient gate -----------------
    batch = torch.randint(0, cfg.vocab_size, (D_256_BATCH[0],
                                              D_256_BATCH[1] + 1),
                          generator=gen, device=dev, dtype=torch.int32)
    tcfg = dataclasses.replace(cfg, attn_impl="flash", remat=False)
    masters = {name: t.float() for name, t in params.items()}
    del params

    def plain_bhld(q, k, v, causal=True, valid_len=0, segments=None):
        return fa.flash_attention_plain(q, k, v, causal, valid_len,
                                        segments)[0]

    def first_grads(model_cfg, plain_attn):
        model = load_model(model_cfg, masters, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = (mock.patch.object(transformer, "flash_attention_bhld",
                                   plain_bhld) if plain_attn
                 else nullcontext())
        with patch:
            loss, _ = loss_fn(batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [name for name, _ in model.named_parameters()]
        out = dict(zip(names, (g.float() for g in grads)))
        del model
        return loss.item(), out

    reset_counts(mods)
    loss_k, grads_k = first_grads(tcfg, False)
    torch.cuda.synchronize()
    paths["d256_train"] = launched = read_counts(mods)
    loss_p, grads_p = first_grads(tcfg, True)
    loss_32, grads_32 = first_grads(
        dataclasses.replace(tcfg, dtype=torch.float32), True)
    ratios = {name: ((grads_k[name] - grads_32[name]).norm()
                     / (grads_p[name] - grads_32[name]).norm()).item()
              for name in grads_32}
    worst = max(ratios, key=ratios.get)
    print(f"[d256] (c) one forward and backward, batch "
          f"{D_256_BATCH[0]} x {D_256_BATCH[1]}: loss kernel {loss_k:.6f} "
          f"plain {loss_p:.6f} fp32 {loss_32:.6f}; gradient gate, "
          f"{len(ratios)} tensors, ||g - g_fp32|| kernel / plain median "
          f"{statistics.median(ratios.values()):.3f}, max "
          f"{ratios[worst]:.3f} at {worst} (limit {GRAD_NOISE_MULT:g}); "
          f"launches {launched}")
    if (launched["flash_fwd"], launched["flash_bwd_dq"],
            launched["flash_bwd_dkv"]) != (n, n, n):
        fail(f"the head-dim-256 step launched {launched}; expected "
             f"{n}/{n}/{n}")
    if not all(torch.isfinite(g).all() for g in grads_k.values()) or (
            ratios[worst] > GRAD_NOISE_MULT):
        fail("the head-dim-256 model's gradients stray further from the "
             "fp32 model's than bf16 rounding explains")
    del grads_k, grads_p, grads_32, masters
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[time] phase 5b {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "rows": rows}


#: phase 13's trainer: llama2_1b at full width and depth, 2 steps of this
#: batch x sequence
TORCHJOB_BATCH, TORCHJOB_SEQ = 2, 512
TORCHJOB_ARGV = ["--config", "llama2_1b", "--steps", "2", "--batch",
                 str(TORCHJOB_BATCH), "--seq-len", str(TORCHJOB_SEQ)]


def torchjob_phase(gpu: str, tmp: Path) -> None:
    """Phase 13: a TorchJob reconciled by the port's job controller runs
    the port's trainer on the card from its pod's env (module docstring)."""
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import (
        Container,
        ObjectMeta,
        Pod,
        PodSpec,
        PodTemplateSpec,
    )
    from tpu_on_k8s_torch.api.types import (
        GPUPolicy,
        JobConditionType,
        TaskSpec,
        TaskType,
        TorchJob,
        TorchJobSpec,
    )
    from tpu_on_k8s_torch.client import InMemoryCluster, KubeletSim
    from tpu_on_k8s_torch.controller.runtime import Manager
    from tpu_on_k8s_torch.controller.torchjob import (
        setup_torchjob_controller,
        submit_job,
    )
    from tpu_on_k8s_torch.utils import conditions

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    cluster, manager = InMemoryCluster(), Manager()
    engine = setup_torchjob_controller(cluster, manager)
    sim = KubeletSim(cluster)
    tpu_env = {"PJRT_DEVICE", "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
               "TPU_PROCESS_ID", "TPU_NUM_PROCESSES",
               "XLA_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
               "MEGASCALE_SLICE_ID", "MEGASCALE_COORDINATOR_ADDRESS",
               "LIBTPU_INIT_ARGS", "JAX_COMPILATION_CACHE_DIR"}

    def submit(name: str, command: list) -> float:
        template = PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, image="tpu-on-k8s-torch",
            command=command)]))
        submit_job(cluster, TorchJob(
            metadata=ObjectMeta(name=name),
            spec=TorchJobSpec(
                tasks={TaskType.MASTER: TaskSpec(num_tasks=1,
                                                 template=template)},
                gpu_policy=GPUPolicy(accelerator="nvidia-h100-80gb",
                                     topology="1x1"))))
        return time.perf_counter()

    def pod_of(name: str) -> Pod:
        manager.run_until_idle()
        pod = cluster.try_get(Pod, "default", f"{name}-master-0")
        if pod is None:
            fail(f"the TorchJob {name} made no pod")
        return pod

    def condition(name: str) -> str:
        job = cluster.get(TorchJob, "default", name)
        if not job.status.conditions:
            return ""
        return getattr(job.status.conditions[-1].type, "value",
                       job.status.conditions[-1].type)

    def kubelet_run(pod: Pod, timeout: float) -> tuple:
        """Run the pod's container as a kubelet would: its command and
        args, exactly its env on top of PATH and HOME; report the exit
        code back on the pod."""
        sim.run_pod("default", pod.metadata.name)
        manager.run_until_idle()
        c = pod.spec.containers[0]
        env = {e.name: e.value for e in c.env if e.value is not None}
        proc = subprocess.run(
            c.command + c.args, cwd=str(root), capture_output=True,
            text=True, timeout=timeout,
            env={"PATH": os.environ.get("PATH", ""),
                 "HOME": os.environ.get("HOME", str(root)), **env})
        sim.terminate_pod("default", pod.metadata.name, proc.returncode,
                          reason="Completed" if proc.returncode == 0
                          else "Error")
        manager.run_until_idle()
        return proc, env

    # ---- (a) the trainer from the pod's env ------------------------------
    argv = TORCHJOB_ARGV
    t_submit = submit("train", [sys.executable, "-m",
                                "tpu_on_k8s_torch.train_llama", *argv])
    pod = pod_of("train")
    main = pod.spec.containers[0]
    env = {e.name: e.value for e in main.env if e.value is not None}
    want = {constants.ENV_MASTER_ADDR: "localhost",
            constants.ENV_MASTER_PORT: str(constants.DEFAULT_COORDINATOR_PORT),
            constants.ENV_PROCESS_ID: "0", constants.ENV_NUM_PROCESSES: "1"}
    if ({k: env.get(k) for k in want} != want or tpu_env & set(env)
            or main.resources.requests.get(constants.RESOURCE_GPU) != 8):
        fail(f"the TorchJob's pod env {env} / requests "
             f"{main.resources.requests}")
    sim.run_pod("default", pod.metadata.name)
    manager.run_until_idle()
    if condition("train") != JobConditionType.RUNNING.value:
        fail(f"the TorchJob is {condition('train')!r}, not Running")
    t_running = time.perf_counter()
    proc, _ = kubelet_run(cluster.get(Pod, "default", "train-master-0"), 300)
    lines = proc.stdout.splitlines()
    mesh_lines = [ln for ln in lines if "mesh=" in ln]
    metric_lines = [ln for ln in lines if ln.startswith("[elastic-metrics]")]
    if proc.returncode != 0 or not mesh_lines or len(metric_lines) != 2:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        fail(f"the TorchJob's trainer exited {proc.returncode} with "
             f"{len(metric_lines)} metric lines")
    if condition("train") != JobConditionType.SUCCEEDED.value:
        fail(f"the TorchJob is {condition('train')!r}, not Succeeded")
    t_done = time.perf_counter()
    print(f"[torchjob] (a) TorchJob 'train' (Master x1, 1x1 "
          f"nvidia-h100-80gb): env {want}, nvidia.com/gpu 8; "
          f"train_llama {' '.join(argv)} from the pod's env: exit 0, "
          f"{mesh_lines[0]}; the last metric line "
          f"{metric_lines[-1]}")
    print(f"[torchjob] (a) submit to Running {t_running - t_submit:.3f} s, "
          f"submit to Succeeded {t_done - t_submit:.3f} s (the trainer's "
          f"process {t_done - t_running:.3f} s) on {gpu}")

    # ---- (b) a retryable exit is recreated; a permanent one fails --------
    marker = tmp / "torchjob_retry.marker"
    retry = ("import os, pathlib, sys; p = pathlib.Path(sys.argv[1]); "
             "assert os.environ['RANK'] == '0' and os.environ['WORLD_SIZE'] "
             "== '1'; first = not p.exists(); p.touch(); "
             "sys.exit(138 if first else 0)")
    submit("retry", [sys.executable, "-c", retry, str(marker)])
    first = pod_of("retry")
    proc, _ = kubelet_run(first, 60)
    second = pod_of("retry")
    restarting = condition("retry")
    if (proc.returncode != 138 or second.metadata.uid == first.metadata.uid
            or second.status.phase != "Pending"
            or restarting != JobConditionType.RESTARTING.value):
        fail(f"exit {proc.returncode}: the pod was not recreated "
             f"({first.metadata.uid} -> {second.metadata.uid}, "
             f"{second.status.phase}, {restarting!r})")
    proc, _ = kubelet_run(second, 60)
    if proc.returncode != 0 or condition("retry") != "Succeeded":
        fail(f"the recreated pod exited {proc.returncode}; the job is "
             f"{condition('retry')!r}")
    submit("permanent", [sys.executable, "-c", "raise SystemExit(1)"])
    proc, _ = kubelet_run(pod_of("permanent"), 60)
    job = cluster.get(TorchJob, "default", "permanent")
    if (proc.returncode != 1 or not conditions.is_failed(job.status)
            or job.status.conditions[-1].reason != "PodFailed"):
        fail(f"exit {proc.returncode}: the job is "
             f"{[(c.type, c.reason) for c in job.status.conditions]}")
    counters = dict(engine.metrics.counters)
    print(f"[torchjob] (b) exit 138 -> pod recreated ({restarting}), then "
          f"exit 0 -> Succeeded; exit 1 -> Failed (PodFailed); job "
          f"metrics {counters}")
    if counters.get("restarted") != 1 or counters.get("successful") != 2 \
            or counters.get("failed") != 1:
        fail(f"the job metrics {counters}")
    print(f"[time] phase 13 {time.perf_counter() - t_phase:.1f} s")


#: phase 14's trainer: gpt2_small at full width and depth, this batch x
#: sequence; the autoscaler decides on ELASTIC_STEPS step times (its
#: ``elastic_metric_count`` is 5)
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_STEPS = 8, 1024, 6


def elastic_phase(mods, gpu: str, dev, tmp: Path, transformer) -> dict:
    """Phase 14: an elastic TorchJob driven by the card (module docstring).
    Returns {"paths": {"elastic": launches}}."""
    import contextlib
    import io

    from tpu_on_k8s_torch import aimaster
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import (
        Container,
        ObjectMeta,
        Pod,
        PodSpec,
        PodTemplateSpec,
    )
    from tpu_on_k8s_torch.api.crr import ContainerRecreateRequest
    from tpu_on_k8s_torch.api.types import (
        ElasticPolicy,
        GPUPolicy,
        TaskSpec,
        TaskType,
        TorchJob,
        TorchJobSpec,
    )
    from tpu_on_k8s_torch.client import InMemoryCluster, KubeletSim
    from tpu_on_k8s_torch.client.nodeagent import NodeAgentLoop
    from tpu_on_k8s_torch.client.testing import append_pod_log
    from tpu_on_k8s_torch.controller.autoscaler import setup_elastic_autoscaler
    from tpu_on_k8s_torch.controller.elastic import ElasticController
    from tpu_on_k8s_torch.controller.failover import CRRRestarter
    from tpu_on_k8s_torch.controller.runtime import Manager
    from tpu_on_k8s_torch.controller.torchjob import (
        setup_torchjob_controller,
        submit_job,
    )
    from tpu_on_k8s_torch.gang import topology
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.obs.ledger import COMMIT_LANDED, DecisionLedger
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    from tpu_on_k8s_torch.train.trainer import train_state_template
    from tpu_on_k8s_torch.train_llama import StepTimer

    t_phase = time.perf_counter()
    name, ns = "elastic", "default"
    w0, w1 = f"{name}-worker-0", f"{name}-worker-1"

    # ---- the operator plane on an in-memory cluster ----------------------
    cluster, manager = InMemoryCluster(), Manager()
    restarter = CRRRestarter(cluster)
    elastic = ElasticController(cluster, restarter=restarter)
    setup_torchjob_controller(cluster, manager, restarter=restarter,
                              elastic_controller=elastic)
    sim = KubeletSim(cluster)
    agent = NodeAgentLoop(cluster, runtime=KubeletSim(cluster))
    ledger = DecisionLedger()
    scaler = setup_elastic_autoscaler(cluster, ledger=ledger)
    # live mode, as deployed: the controllers on their worker threads and
    # the node agent on its watch; the kubelet is stepped by hand
    manager.start()
    agent.start()

    def settle(done, what: str, timeout: float = 60.0) -> None:
        """Run what is pending until ``done()`` holds."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            sim.run_all(ns)
            if done():
                return
            time.sleep(0.01)
        fail(f"phase 14: timed out waiting for {what}")

    def job():
        return cluster.get(TorchJob, ns, name)

    def pod(pod_name):
        return cluster.try_get(Pod, ns, pod_name)

    def env_of(p) -> dict:
        return {e.name: (e.value_from.field_path if e.value_from is not None
                         else e.value)
                for e in p.spec.containers[0].env}

    template = PodTemplateSpec(spec=PodSpec(containers=[Container(
        name=constants.DEFAULT_CONTAINER_NAME, image="tpu-on-k8s-torch")]))
    submit_job(cluster, TorchJob(
        metadata=ObjectMeta(name=name),
        spec=TorchJobSpec(
            tasks={TaskType.WORKER: TaskSpec(num_tasks=1, template=template)},
            elastic_policy=ElasticPolicy(min_replicas=1, max_replicas=2),
            gpu_policy=GPUPolicy(accelerator="nvidia-h100-80gb",
                                 topology="1x8"))))

    def running(pod_name: str, generation: int) -> bool:
        p = pod(pod_name)
        return (p is not None and p.status.phase == "Running"
                and p.metadata.deletion_timestamp is None
                and p.metadata.labels.get(constants.LABEL_JOB_GENERATION)
                == str(generation))

    settle(lambda: running(w0, 1), "worker-0 running")
    first = pod(w0)
    if scaler.registered() != [f"{ns}/{name}"]:
        fail(f"the autoscaler registered {scaler.registered()}")

    # ---- the trainer on the card -----------------------------------------
    tcfg = dataclasses.replace(transformer.TransformerConfig.gpt2_small(),
                               attn_impl="flash")
    opt_kw = dict(warmup_steps=10, decay_steps=11)
    p0 = init_params(tcfg, torch.Generator(device=dev).manual_seed(14), dev,
                     dtype=torch.float32)
    model = load_model(tcfg, p0, dev)
    trainer = Trainer(model, default_optimizer(model.parameters(), **opt_kw))
    state = trainer.state()
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, tcfg.vocab_size, (ELASTIC_BATCH, ELASTIC_SEQ + 1))
        .astype(np.int32)).to(dev)
    timer = StepTimer(ELASTIC_BATCH * ELASTIC_SEQ)
    n = tcfg.n_layers
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}

    # ---- (a) grow 1 -> 2 on the card's own step times ----------------------
    torch.cuda.synchronize()
    reset_counts(mods)
    step_s, losses = [], []
    for i in range(ELASTIC_STEPS):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, tokens)
        loss = float(m["loss"])                 # syncs: the step is done
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            timer.report(state.step, loss, step_s[-1])
        [line] = out.getvalue().splitlines()
        append_pod_log(cluster, ns, w0, line)
    scaler.run_once()
    decisions = list(scaler.decision_log)
    records = [r for r in ledger.records if hasattr(r, "action")]
    if (len(decisions) != 1 or len(records) != 1
            or records[0].action != "up" or records[0].commit != COMMIT_LANDED
            or (records[0].current, records[0].target) != (1, 2)):
        fail(f"the autoscaler did not grow 1 -> 2 on the card's step times: "
             f"{decisions}, {ledger.lines()}")
    print(f"[elastic] (a) {ELASTIC_STEPS} gpt2_small steps at "
          f"{ELASTIC_BATCH} x {ELASTIC_SEQ} on {gpu}: step s "
          f"{[round(x, 4) for x in step_s]}, loss "
          f"{[round(x, 4) for x in losses]}; worker-0's last line "
          f"'{line}'")
    print(f"[elastic] (a) decision: {decisions[0]}")
    print(f"[elastic] (a) ledger: {ledger.lines()[0]}")
    t0 = time.perf_counter()
    settle(lambda: running(w0, 2) and running(w1, 2) and job().metadata
           .annotations.get(constants.ANNOTATION_SCALE_STATE)
           == constants.SCALE_STATE_DONE
           and not cluster.list(ContainerRecreateRequest, ns),
           "the grown world at generation 2")
    grow_s = time.perf_counter() - t0
    j = job()
    grown0, grown1 = pod(w0), pod(w1)
    crrs = cluster.list(ContainerRecreateRequest, ns)
    if (j.spec.tasks[TaskType.WORKER].num_tasks != 2
            or j.spec.gpu_policy.topology != "2x8"
            or j.metadata.generation != 2 or grown1 is None
            or env_of(grown1).get(constants.ENV_PROCESS_ID) != "1"
            or grown0.metadata.uid != first.metadata.uid
            or grown0.metadata.annotations.get(
                constants.ANNOTATION_WORLD_SIZE) != "2"
            or grown0.metadata.annotations.get(
                constants.ANNOTATION_ELASTIC_RESTARTS) != "1"
            or agent.executed != 1 or crrs):
        fail(f"the grow was not applied as a respec to 2x8 with worker-0 "
             f"restarted in place: generation {j.metadata.generation}, "
             f"{j.spec.gpu_policy.topology}, worker-1 {grown1 and env_of(grown1)}"
             f", worker-0 {grown0.metadata.annotations}, node agent "
             f"{agent.executed}, CRRs left {len(crrs)}")
    print(f"[elastic] (a) respec: generation {j.metadata.generation}, 2 "
          f"workers, 2x8; worker-1 RANK=1 MASTER_ADDR="
          f"{env_of(grown1)[constants.ENV_MASTER_ADDR]}; worker-0 restarted "
          f"in place by the node agent's CRR (uid kept, world-size 2, "
          f"elastic-restarts 1, RANK={env_of(grown0)[constants.ENV_PROCESS_ID]})"
          f"; decision to the grown world running {grow_s:.3f} s")

    # ---- (b) checkpoint the card's state on the controller's request -------
    mgr = CheckpointManager(str(tmp / "elastic_ckpt"), max_to_keep=1)
    nbytes = sum(t.numel() * t.element_size()
                 for t in state.state_dict().values())
    saved_at = {}

    def save_fn(generation: int) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state, step=int(state.step), generation=generation)
        saved_at["s"] = time.perf_counter() - t0
        saved_at["generation"] = generation

    cluster.delete(Pod, ns, w1)              # held by its finalizer: a victim
    t_request = time.perf_counter()
    settle(lambda: job().metadata.annotations.get(
        constants.ANNOTATION_CKPT_REQUESTED_VERSION) is not None,
        "the checkpoint request")
    gen_req = job().metadata.annotations.get(
        constants.ANNOTATION_CKPT_REQUESTED_VERSION)
    if gen_req != "2" or pod(w1) is None:
        fail(f"no checkpoint request for the victim: {gen_req}")
    done = aimaster.run(cluster, ns, name, save_fn, period_seconds=0,
                        max_polls=1)
    ack_s = time.perf_counter() - t_request
    settle(lambda: running(w0, 3) and pod(w1) is None and job().metadata
           .annotations.get(constants.ANNOTATION_SCALE_STATE)
           == constants.SCALE_STATE_DONE
           and not cluster.list(ContainerRecreateRequest, ns),
           "the shrunk world at generation 3")
    agent.stop()
    manager.stop()
    j = job()
    shrunk0 = pod(w0)
    if (done != 1 or saved_at.get("generation") != 2
            or j.metadata.annotations.get(
                constants.ANNOTATION_CKPT_COMPLETED_VERSION) != "2"
            or pod(w1) is not None
            or j.spec.tasks[TaskType.WORKER].num_tasks != 1
            or topology.hosts_per_slice(j.spec.gpu_policy.accelerator,
                                        j.spec.gpu_policy.topology) != 1
            or j.metadata.generation != 3
            or shrunk0.metadata.uid != first.metadata.uid
            or shrunk0.metadata.annotations.get(
                constants.ANNOTATION_WORLD_SIZE) != "1"):
        fail(f"the checkpoint round did not drain the victim and respec to "
             f"1 host: done {done}, saved {saved_at}, generation "
             f"{j.metadata.generation}, {j.spec.gpu_policy.topology}, "
             f"worker-0 {shrunk0.metadata.annotations}")
    print(f"[elastic] (b) worker-1 preempted: checkpoint requested at "
          f"generation {gen_req}; the AIMaster saved the card's TrainState "
          f"({nbytes:,} B, step {int(state.step)}) in {saved_at['s']:.2f} s "
          f"({nbytes / saved_at['s'] / 1e9:.3f} GB/s) and acknowledged "
          f"{ack_s:.2f} s after the request; respec to 1 host "
          f"({j.spec.gpu_policy.topology}, the first legal one-host shape, as "
          f"the reference's topology_for_hosts picks), generation "
          f"{j.metadata.generation}, worker-0 restarted in place again "
          f"(elastic-restarts "
          f"{shrunk0.metadata.annotations[constants.ANNOTATION_ELASTIC_RESTARTS]})")

    # ---- (c) restore into a fresh state; one more step on each ------------
    fresh = train_state_template(tcfg, dev, **opt_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, gen, step = mgr.restore(fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live_sd, back_sd = state.state_dict(), restored.state_dict()
    same = [k for k, t in live_sd.items() if torch.equal(back_sd[k], t)]
    trainer2 = Trainer(restored.model, restored.optimizer)
    restored, m_back = trainer2.train_step(restored, tokens)
    state, m_live = trainer.train_step(state, tokens)
    loss_back, loss_live = float(m_back["loss"]), float(m_live["loss"])
    torch.cuda.synchronize()
    launched = read_counts(mods)
    want = {k: v * (ELASTIC_STEPS + 2) for k, v in per_step.items()}
    print(f"[elastic] (c) restored generation {gen} step {step} into a fresh "
          f"TrainState in {restore_s:.2f} s ({nbytes / restore_s / 1e9:.3f} "
          f"GB/s): {len(same)} of {len(live_sd)} tensors bit-identical; one "
          f"more step: step {int(restored.step)}, loss {loss_back!r} "
          f"restored vs {loss_live!r} never checkpointed; launches "
          f"{launched}")
    if (len(same) != len(live_sd) or gen != 2 or step != ELASTIC_STEPS
            or int(restored.step) != step + 1 or loss_back != loss_live
            or not math.isfinite(loss_back)):
        fail("the restored state is not the saved one, or its next step "
             "differs from the live state's")
    if any(launched[k] != v for k, v in want.items()) or any(
            c for k, c in launched.items() if k not in want):
        fail(f"phase 14 launches {launched}; expected {want}")
    mgr.close()
    del trainer, trainer2, state, restored, fresh, model, p0
    torch.cuda.empty_cache()
    print(f"[time] {gpu}: phase 14 gpt2_small step median "
          f"{statistics.median(step_s[1:]) * 1e3:.1f} ms; save "
          f"{saved_at['s']:.2f} s, restore {restore_s:.2f} s of "
          f"{nbytes:,} B; request to ack {ack_s:.2f} s")
    print(f"[time] phase 14 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": {"elastic": launched}}


class FakeClock:
    """A virtual clock the fleet, its gateways, the autoscaler and the
    InferenceService reconciler share (``tests/test_autoscale.py``'s)."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def slo_rendered(statuses) -> dict:
    """The engine's statuses as the autoscaler renders ``status.slo``."""
    from tpu_on_k8s_torch.api.inference_types import SLOObjectiveStatus
    return {name: SLOObjectiveStatus(
        objective=st.objective, target=st.target, state=st.state,
        burn_fast=-1.0 if st.burn_fast is None else round(st.burn_fast, 4),
        burn_slow=-1.0 if st.burn_slow is None else round(st.burn_slow, 4),
        budget_remaining=round(st.budget_remaining, 4), stale=st.stale)
        for name, st in statuses.items()}


def replica_pods_follow(cluster, svc) -> str:
    """'' when the replica pods of ``svc`` follow its ``spec.replicas``
    (live gangs of ``nvidia.com/gpu`` 8 with the accelerator selector and
    no name that says TPU; draining ones aside), else why."""
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import Pod

    live = {}
    selector = {constants.LABEL_INFERENCESERVICE_NAME: svc.metadata.name}
    for pod in cluster.list(Pod, svc.metadata.namespace, selector):
        [c] = pod.spec.containers
        names = [e.name for e in c.env] + list(pod.spec.node_selector) \
            + list(c.resources.requests) + list(c.resources.limits)
        if (c.resources.requests.get(constants.RESOURCE_GPU) != 8
                or c.resources.limits.get(constants.RESOURCE_GPU) != 8
                or pod.spec.node_selector != {
                    constants.NODE_SELECTOR_GPU_ACCELERATOR:
                        FLEET_ACCELERATOR}
                or any("tpu" in n.lower() for n in names)):
            return f"pod {pod.metadata.name} is not of the GPU flavour"
        if constants.ANNOTATION_SERVING_DRAIN_DEADLINE \
                in pod.metadata.annotations:
            continue
        if pod.status.phase != "Running":
            return f"pod {pod.metadata.name} is {pod.status.phase}"
        live.setdefault(pod.metadata.labels[
            constants.LABEL_SERVING_REPLICA_INDEX], []).append(pod)
    want = {str(i) for i in range(svc.spec.replicas)}
    if set(live) != want:
        return f"live replica gangs {sorted(live)}, spec {sorted(want)}"
    return ""


def burst_arrivals(step: int, rng, tokens_rng, vocab: int) -> list:
    """The burst's arrivals at fleet step ``step``: 3-5 requests a step over
    FLEET_BURST's steps, prompts of 64-896 tokens with 16-64 new (from
    ``rng``), the prompt tokens from ``tokens_rng``."""
    out = []
    if FLEET_BURST[0] <= step < FLEET_BURST[1]:
        for _ in range(int(rng.integers(3, 6))):
            n = int(rng.integers(64, 897))
            new = int(rng.integers(16, 65))
            out.append((tokens_rng.integers(0, vocab, size=n).astype(np.int32),
                        new))
    return out


def fleet_burst(cfg, params, device, *, seed, injector=None) -> dict:
    """``tests/test_autoscale.py::_drive_burst``, the acceptance loop of
    the serving autoscaler, over engines of ``cfg`` and ``params`` on
    ``device`` (FLEET_SLOTS slots x FLEET_MAX_LEN positions, one weight set
    shared by every replica, each replica its own cache), with the
    InferenceService CRD plane on the same cluster: a ``ServingFleet``
    (slow start 1, prefix bucket 8) on a fake clock that advances
    FLEET_DT a fleet step; a ``FleetAutoscaler`` attached to it ticks
    every second step under FLEET_POLICY; after each tick the reconciler
    (``setup_inferenceservice_controller`` on a ``Manager``) turns the
    patched ``spec.replicas`` into replica gangs and a ``KubeletSim`` runs
    their pods. The burst: 3-5 requests a step over FLEET_BURST's steps
    from numpy ``seed``, prompt lengths and new tokens as phase 6 (c)'s,
    the prompt tokens from a second stream. After every tick the replica
    pods must follow ``spec.replicas`` (live gangs, ``nvidia.com/gpu`` 8,
    the accelerator selector, no name that says TPU) and ``status.slo``
    must be the SLO engine's state. Returns what the gates read."""
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import ObjectMeta
    from tpu_on_k8s_torch.api.inference_types import (
        AutoscalePolicy,
        InferenceService,
        InferenceServiceSpec,
        RolloutPolicy,
        SLOObjective,
        SLOPolicy,
    )
    from tpu_on_k8s_torch.api.types import GPUPolicy
    from tpu_on_k8s_torch.client import InMemoryCluster, KubeletSim
    from tpu_on_k8s_torch.controller.config import JobControllerConfig
    from tpu_on_k8s_torch.controller.fleetautoscaler import FleetAutoscaler
    from tpu_on_k8s_torch.controller.inferenceservice import (
        setup_inferenceservice_controller,
    )
    from tpu_on_k8s_torch.controller.runtime import Manager
    from tpu_on_k8s_torch.metrics import AutoscaleMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        ProbeConfig,
        Rejected,
        Router,
        ServingFleet,
    )

    clock = FakeClock()
    engines = []

    def factory(name):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=FLEET_SLOTS,
                                       max_len=FLEET_MAX_LEN, device=device)
        engines.append(eng)
        return eng

    fleet = ServingFleet(factory, 1, probe=ProbeConfig(slow_start_steps=1),
                         router=Router(prefix_bucket_len=8), clock=clock)
    cluster = InMemoryCluster()
    manager = Manager()
    setup_inferenceservice_controller(cluster, manager, clock=clock)
    sim = KubeletSim(cluster)
    cluster.create(InferenceService(
        metadata=ObjectMeta(name="svc"),
        spec=InferenceServiceSpec(
            image="inproc", replicas=1,
            gpu_policy=GPUPolicy(accelerator=FLEET_ACCELERATOR,
                                 topology=FLEET_TOPOLOGY),
            rollout=RolloutPolicy(drain_seconds=FLEET_DRAIN_S),
            autoscale=AutoscalePolicy(**FLEET_POLICY),
            # one TTFT objective at the policy's own target
            slo=SLOPolicy(objectives=[SLOObjective(
                name="ttft", objective="ttft_p95",
                target=FLEET_POLICY["target_ttft_s"],
                **FLEET_SLO_WINDOWS)]))))
    metrics = AutoscaleMetrics()
    scaler = FleetAutoscaler(
        cluster, config=JobControllerConfig(autoscale_window_scrapes=3,
                                            autoscale_stale_scrapes=3),
        metrics=metrics, clock=clock)
    scaler.attach_fleet("default", "svc", fleet)
    selector = {constants.LABEL_INFERENCESERVICE_NAME: "svc"}

    def reconcile():
        manager.run_until_idle()
        sim.run_all("default", selector)
        manager.run_until_idle()

    reconcile()
    rng = np.random.default_rng(seed)
    tokens_rng = np.random.default_rng((seed, FLEET_TOKEN_STREAM))
    reqs, rejected, transitions, step_ms = {}, 0, [], []
    ticks = {"n": 0, "slo_checked": 0}
    step, tail = 0, FLEET_TAIL

    def tick():
        before = cluster.get(InferenceService, "default", "svc").spec.replicas
        scaler.run_once()
        svc = cluster.get(InferenceService, "default", "svc")
        if svc.spec.replicas != before:
            transitions.append((clock.t, before, svc.spec.replicas))
        ticks["n"] += 1
        engine = scaler._services["default/svc"].slo_engine
        if engine is not None:
            want = slo_rendered(engine.evaluate())
            if svc.status.slo != want:
                fail(f"tick {ticks['n']}: status.slo {svc.status.slo} is not "
                     f"the SLO engine's state {want}")
            ticks["slo_checked"] += 1
        reconcile()
        why = replica_pods_follow(
            cluster, cluster.get(InferenceService, "default", "svc"))
        if why:
            fail(f"tick {ticks['n']} (t {clock.t:.2f}): the replica pods do "
                 f"not follow spec.replicas: {why}")

    if injector is not None:
        chaos.install(injector)
    try:
        while step < 40 or fleet.has_live_requests or fleet.queue_depth \
                or tail > 0:
            for prompt, new in burst_arrivals(step, rng, tokens_rng,
                                              cfg.vocab_size):
                r = fleet.submit(prompt, new)
                if isinstance(r, Rejected):
                    rejected += 1
                else:
                    reqs[r] = (prompt, new)
            t0 = time.perf_counter()
            fleet.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            clock.advance(FLEET_DT)
            if step % 2 == 0:
                tick()
            if step >= 40 and not fleet.has_live_requests \
                    and not fleet.queue_depth:
                tail -= 1
            step += 1
    finally:
        if injector is not None:
            chaos.uninstall(injector)
    return dict(cluster=cluster, fleet=fleet, scaler=scaler, metrics=metrics,
                transitions=transitions, reqs=reqs, rejected=rejected,
                results={rid: fleet.result(rid) for rid in reqs},
                engines=engines, steps=step, step_ms=step_ms, ticks=ticks,
                svc=cluster.get(InferenceService, "default", "svc"))


def burst_gates(tag: str, env: dict, crash: bool) -> None:
    """``tests/test_autoscale.py``'s assertions on one ``fleet_burst`` run:
    ``test_burst_scales_up_then_down``'s, or with ``crash``
    ``test_autoscale_under_crash_converges_without_thrash``'s."""
    from tpu_on_k8s_torch.gang import topology

    trans, svc, fleet = env["transitions"], env["svc"], env["fleet"]
    dirs = "".join("u" if n > o else "d" for _, o, n in trans)
    if not trans or "u" not in dirs:
        fail(f"{tag}: transitions {trans}: the burst must scale up")
    if dirs != "u" * dirs.count("u") + "d" * dirs.count("d"):
        fail(f"{tag}: the executed scales thrash: {dirs}")
    states = Counter(r.state.value if r is not None else None
                     for r in env["results"].values())
    log = list(env["scaler"].decision_log)
    if crash:
        # not "back at 1": where the first scale goes 1 -> 4 in one step
        # and the crash lands after it, the reference's loop holds at 4
        # with 3 ready (its Recommender never shrinks a world that has not
        # assembled, and nothing replaces an ejected replica outside a
        # scale); the CPU twin's byte-identical log holds that state to
        # the reference's logic, which tests/test_torch_autoscale_diff.py
        # holds to the JAX package's
        if fleet.stats["ejected"] != 1:
            fail(f"{tag}: {fleet.stats['ejected']} ejections, not the "
                 f"crashed replica's one")
        if not any("stale_signal" in line for line in log):
            fail(f"{tag}: the outage ticks did not hold as stale")
        if set(states) - {"done", "retry_exhausted"}:
            fail(f"{tag}: requests ended {dict(states)}")
        return
    if svc.spec.replicas != 1 or "d" not in dirs:
        fail(f"{tag}: transitions {trans}, spec.replicas "
             f"{svc.spec.replicas}: the burst must scale back down to 1")
    legal = set(topology.legal_host_counts(FLEET_ACCELERATOR))
    if any(new not in legal for _, _, new in trans):
        fail(f"{tag}: a transition off the legal host counts {trans}")
    for (t1, o1, n1), (t2, o2, n2) in zip(trans, trans[1:]):
        up1, up2 = n1 > o1, n2 > o2
        gap = (FLEET_POLICY["scale_up_cooldown_s"] if up1 and up2 else
               FLEET_POLICY["scale_down_cooldown_s"]
               if not up1 and not up2 else FLEET_POLICY["flap_guard_s"])
        if t2 - t1 < gap - 1e-9:
            fail(f"{tag}: scales at {t1:.2f} and {t2:.2f} s closer than "
                 f"{gap} s")
    if set(states) != {"done"} or fleet.stats["ejected"]:
        fail(f"{tag}: requests ended {dict(states)}, ejected "
             f"{fleet.stats['ejected']}")
    if not all(rec["drained_clean"] for rec in fleet.retired):
        fail(f"{tag}: a retired replica did not drain clean: "
             f"{fleet.retired}")
    m = env["metrics"]
    if (svc.status.desired_replicas != 1
            or "down" not in svc.status.autoscale_message
            or m.counters[("decisions", "up")] < 1
            or m.counters[("decisions", "down")] < 1
            or m.gauges[("desired_replicas", "default/svc")] != 1):
        fail(f"{tag}: status desired {svc.status.desired_replicas} "
             f"{svc.status.autoscale_message!r}, decisions "
             f"{dict(m.counters)}")


def fleet_autoscale_phase(mods, gpu, dev, plain_flash, transformer, decode,
                          convert, diff) -> dict:
    """Phase 15: the serving control plane (``controller/fleetautoscaler.py``,
    ``controller/inferenceservice.py``, ``obs/slo.py``) closing the loop
    over gpt2_small replicas on the card. (a) ``fleet_burst`` at gpt2_small's
    full width and depth in bf16 (phase 6's tree, from its torch seed), its
    flash forward launches the path ``fleet_autoscale``; the gates of
    ``burst_gates``, the decision log byte-identical to the same loop's at
    the ``tiny`` config on the CPU (with gpt2_small's vocabulary and
    positions, so that both runs take the same prompts: the router hashes a
    prompt's first tokens), and every emitted token within phase 6 (c)'s tau
    of a teacher-forced maximum, at least its exact share the argmax. (b)
    the same at seed FLEET_CRASH_SEED under ``autoscale_under_crash``: the
    crash's gates, its log against its CPU twin's too, and the tokens of
    its done requests through the same teacher-forced gate. The flash
    launches of both runs (counts set to 0 before each, read after) are
    the path ``fleet_autoscale``. Returns the launches by path."""
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.models.params import init_params, keeps_fp32
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    t_phase = time.perf_counter()
    hcfg, params = gpt2_small_tree(convert, init_params, dev)
    cfg = dataclasses.replace(hcfg, dtype=torch.bfloat16)
    bparams = {n: t if keeps_fp32(n) else t.to(torch.bfloat16)
               for n, t in params.items()}
    del params
    twin_cfg = dataclasses.replace(
        TransformerConfig.tiny(), max_seq_len=FLEET_MAX_LEN,
        vocab_size=cfg.vocab_size, dtype=torch.float32)
    twin = init_params(twin_cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)

    def crash_injector():
        return chaos.autoscale_under_crash(
            replica="replica-1", crash_at=3, outage_at=(2, 3, 4),
            seed=FLEET_CRASH_SEED).injector()

    runs, paths = {}, {}
    for key, seed in (("a", FLEET_SEED), ("b", FLEET_CRASH_SEED)):
        t0 = time.perf_counter()
        cpu = fleet_burst(twin_cfg, twin, "cpu", seed=seed,
                          injector=crash_injector() if key == "b" else None)
        cpu_s = time.perf_counter() - t0
        inj = crash_injector() if key == "b" else None
        torch.cuda.synchronize()
        reset_counts(mods)
        t0 = time.perf_counter()
        env = fleet_burst(cfg, bparams, dev, seed=seed, injector=inj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = read_counts(mods)
        paths["fleet_autoscale"] = {
            k: c + paths.get("fleet_autoscale", {}).get(k, 0)
            for k, c in launched.items()}
        env.update(wall=wall, launched=launched, cpu_s=cpu_s,
                   chaos=None if inj is None else list(inj.events))
        runs[key] = env
        log = "\n".join(env["scaler"].decision_log).encode()
        cpu_log = "\n".join(cpu["scaler"].decision_log).encode()
        fresh = sum(e.stats["fresh_prefills"] for e in env["engines"])
        aliased = all(t.data_ptr() == bparams[n].data_ptr()
                      for e in env["engines"]
                      for m in (e._prefill_model, e._step_model)
                      for n, t in m.named_parameters())
        ended = Counter(r.state.value for r in env["results"].values())
        routable = sorted(n for n, r in env["fleet"].replicas.items()
                          if r.routable)
        label = ("the burst" if key == "a" else
                 "the burst under autoscale_under_crash(replica-1, crash_at 3,"
                 " outage_at (2, 3, 4))")
        print(f"[fleet] ({key}) {label}, seed {seed}: {len(env['reqs'])} "
              f"requests ({env['rejected']} rejected), "
              f"{sum(len(r.tokens) for r in env['results'].values())} tokens,"
              f" {env['steps']} fleet steps, {env['ticks']['n']} ticks "
              f"({env['ticks']['slo_checked']} with status.slo checked "
              f"against the SLO engine, the replica pods checked against "
              f"spec.replicas after each); {len(env['engines'])} replica "
              f"engines over one weight set (every parameter aliased: "
              f"{aliased}); results {dict(ended)}; "
              f"fleet stats {dict(env['fleet'].stats)}")
        print(f"[fleet] ({key}) transitions (virtual s, from, to): "
              f"{[(round(t, 2), o, n) for t, o, n in env['transitions']]}; "
              f"decision log {len(env['scaler'].decision_log)} lines, "
              f"{len(log)} B, byte-identical to the CPU twin's "
              f"(tiny, {cpu_s:.1f} s): {log == cpu_log}; chaos "
              f"{env['chaos']}")
        print(f"[fleet] ({key}) launches {launched} = {cfg.n_layers} x "
              f"{fresh} fresh prefills on {len(env['engines'])} replicas; "
              f"status.slo {env['svc'].status.slo}; spec.replicas "
              f"{env['svc'].spec.replicas}, routable replicas "
              f"{routable}")
        print(f"[time] {gpu}: phase 15 ({key}) gpt2_small bf16, replicas of "
              f"{FLEET_SLOTS} slots x {FLEET_MAX_LEN}: {env['steps']} fleet "
              f"steps in {wall:.2f} s, host ms a fleet step median "
              f"{statistics.median(env['step_ms']):.2f} (max "
              f"{max(env['step_ms']):.2f}); the CPU twin {cpu_s:.2f} s")
        if not aliased:
            fail("a replica engine copied the shared weights")
        if launched["flash_fwd"] != cfg.n_layers * fresh or not fresh or any(
                c for k, c in launched.items() if k != "flash_fwd"):
            fail(f"phase 15 ({key}) launches {launched} for {fresh} fresh "
                 f"prefills")
        if log != cpu_log:
            mine, twins = env["scaler"].decision_log, cpu["scaler"].decision_log
            first = next((i for i, (x, y) in enumerate(zip(mine, twins))
                          if x != y), min(len(mine), len(twins)))
            fail(f"phase 15 ({key}) decision log differs from the CPU "
                 f"twin's at line {first}")
        burst_gates(f"phase 15 ({key})", env, crash=key == "b")
        burst_gates(f"phase 15 ({key}) CPU twin", cpu, crash=key == "b")
        del cpu
    model = decode.decode_model(cfg, bparams, dev)
    tau = GPT2_TAU_MULT * diff
    for key, env in runs.items():
        done = [rid for rid, r in env["results"].items()
                if r.state.value == "done"]
        gaps = teacher_forced_gaps(
            model, [env["reqs"][rid] for rid in done],
            {j: np.asarray(env["results"][rid].tokens)
             for j, rid in enumerate(done)}, None, set(), plain_flash,
            transformer, decode)
        tau_gate(f"[fleet] ({key})", gaps, tau, diff, mult=GPT2_TAU_MULT,
                 exact_min=GPT2_EXACT_MIN, unit="phase 6 (b)'s")
    del model, runs
    torch.cuda.empty_cache()
    print(f"[time] phase 15 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths}


def brokered_burst(cfg, params, device, *, seed, lane_cfg=None,
                   lane_params=None) -> dict:
    """Phase 16 (a)'s market, built by the port's own entry
    (``tpu_on_k8s_torch.main.Operator`` on the in-memory backend, the
    ``JobCoordinator`` gate on, ``--broker-capacity-chips``
    BROKER_CAPACITY), with a ``KubeletSim`` running every pod. Three
    consumers share the market:

    * serving: ``fleet_burst``'s InferenceService (``1x8``, phase 15's
      policy and SLO) with ``spec.broker`` (one unit a replica, rung 1
      off: see BROKER_* above), its operator-built ``FleetAutoscaler``
      attached to a ``ServingFleet`` of ``cfg``/``params`` engines on
      ``device``, under phase 15's burst at ``seed`` on phase 15's fake
      clock;
    * batch: a ``BatchLane`` registered with the operator's broker as a
      managed consumer, fed through ``BatchGatewayBridge`` into a
      ``ServingGateway`` over one more engine (``lane_cfg`` /
      ``lane_params``, default the fleet's), BROKER_LANE_ITEMS seeded
      items; a harvest shrinks the lane and ``yield_excess`` cancels its
      newest gateway requests;
    * training: the elastic TorchJob ``train`` (BROKER_TRAIN_HOSTS hosts,
      floor BROKER_TRAIN_MIN) in tenant queue ``team-train`` beside the
      job ``eval`` in ``team-eval``, both admitted by the operator's
      ``Coordinator`` (default quota and priority plugins, smooth WRR);
      its ``ElasticAutoscaler`` bids through ``_training_bid``.

    Every tick (each second fleet step): the fleet autoscaler, the elastic
    autoscaler and one market clearing, then the operator pumped to
    quiescence and the kubelet run; the batch lane's zero-loss invariant
    is checked after every fleet step and the replica pods after every
    tick. Returns what the gates read."""
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import (
        Container,
        ObjectMeta,
        Pod,
        PodSpec,
        PodTemplateSpec,
    )
    from tpu_on_k8s_torch.api.inference_types import (
        AutoscalePolicy,
        BrokerPolicy,
        InferenceService,
        InferenceServiceSpec,
        RolloutPolicy,
        SLOObjective,
        SLOPolicy,
    )
    from tpu_on_k8s_torch.api.types import (
        ElasticPolicy,
        GPUPolicy,
        RunPolicy,
        SchedulingPolicy,
        TaskSpec,
        TaskType,
        TorchJob,
        TorchJobSpec,
    )
    from tpu_on_k8s_torch.client import KubeletSim
    from tpu_on_k8s_torch.client.testing import append_pod_log
    from tpu_on_k8s_torch.controller.torchjob import submit_job
    from tpu_on_k8s_torch.coordinator.policy import SmoothWRR
    from tpu_on_k8s_torch.main import Operator, build_parser
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        ProbeConfig,
        Rejected,
        Router,
        ServingFleet,
        ServingGateway,
    )
    from tpu_on_k8s_torch.serve.batchlane import BatchGatewayBridge, BatchLane

    clock = FakeClock()
    op = Operator(build_parser().parse_args(
        ["--cluster-backend", "memory", "--feature-gates",
         "JobCoordinator=true", "--broker-capacity-chips",
         str(BROKER_CAPACITY)]))
    # phase 15's loop on the operator's serving controllers: its scrape
    # window and staleness, and its virtual clock for the autoscaler, the
    # InferenceService reconciler and that reconciler's workqueue (phase
    # 15 passed the clock to their constructors; the entry builds them)
    op.config.autoscale_window_scrapes = 3
    op.config.autoscale_stale_scrapes = 3
    op.fleetautoscaler.clock = clock
    op.inferenceservice.clock = clock
    [isvc] = [c for c in op.manager.controllers
              if c.name == "inferenceservice"]
    isvc.queue._clock = clock
    cluster, broker = op.cluster, op.broker
    sim = KubeletSim(cluster)

    def settle():
        op.manager.run_until_idle()
        sim.run_all("default")
        op.manager.run_until_idle()

    # ---- training: two tenant queues through the coordinator ------------
    template = PodTemplateSpec(spec=PodSpec(containers=[Container(
        name=constants.DEFAULT_CONTAINER_NAME, image="tpu-on-k8s-torch")]))
    tenants = {"train": ("team-train", BROKER_TRAIN_HOSTS, "4x8",
                         ElasticPolicy(min_replicas=BROKER_TRAIN_MIN,
                                       max_replicas=BROKER_TRAIN_HOSTS)),
               "eval": ("team-eval", 1, "1x8", None)}
    for name, (queue, hosts, topo, elastic) in tenants.items():
        submit_job(cluster, TorchJob(
            metadata=ObjectMeta(name=name),
            spec=TorchJobSpec(
                tasks={TaskType.WORKER: TaskSpec(num_tasks=hosts,
                                                 template=template)},
                run_policy=RunPolicy(scheduling_policy=SchedulingPolicy(
                    queue=queue)),
                elastic_policy=elastic,
                gpu_policy=GPUPolicy(accelerator=FLEET_ACCELERATOR,
                                     topology=topo))))

    def queuing(name):
        job = cluster.get(TorchJob, "default", name)
        return [(c.status, c.reason) for c in job.status.conditions
                if c.type.value == "Queuing"]

    held = {name: queuing(name) for name in tenants}
    pods_before = len(cluster.list(Pod, "default"))
    # the order smooth WRR gives the two queues, weighted by their tasks
    wrr, weights, expected = SmoothWRR(), {
        q: float(h) for q, h, _, _ in tenants.values()}, []
    while weights:
        queue = wrr.pick(weights)
        expected.append(next(n for n, t in tenants.items() if t[0] == queue))
        del weights[queue]
    order = []
    for _ in range(4):
        key = op.coordinator.schedule_once()
        if key is not None:
            order.append(key.split("/", 1)[1])
        settle()
    admitted = {name: queuing(name) for name in tenants}
    # worker-0 prints BROKER_TRAIN_LINES step lines at one latency, as the
    # port's trainers do: the elastic autoscaler's window fills at its
    # max_replicas and it freezes there (ReachMaxReplicas), so its only
    # later move is the broker's preemption through shrink_to
    for i in range(BROKER_TRAIN_LINES):
        append_pod_log(cluster, "default", "train-worker-0",
                       f"[elastic-metrics] epoch=0 batch={i} latency=0.5")

    # ---- serving: the InferenceService and its fleet ---------------------
    cluster.create(InferenceService(
        metadata=ObjectMeta(name="svc"),
        spec=InferenceServiceSpec(
            image="inproc", replicas=1,
            gpu_policy=GPUPolicy(accelerator=FLEET_ACCELERATOR,
                                 topology=FLEET_TOPOLOGY),
            rollout=RolloutPolicy(drain_seconds=FLEET_DRAIN_S),
            autoscale=AutoscalePolicy(**FLEET_POLICY),
            slo=SLOPolicy(objectives=[SLOObjective(
                name="ttft", objective="ttft_p95",
                target=FLEET_POLICY["target_ttft_s"],
                **FLEET_SLO_WINDOWS)]),
            broker=BrokerPolicy(degrade=False))))
    engines = []

    def factory(name):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=FLEET_SLOTS,
                                       max_len=FLEET_MAX_LEN, device=device)
        engines.append(eng)
        return eng

    fleet = ServingFleet(factory, 1, probe=ProbeConfig(slow_start_steps=1),
                         router=Router(prefix_bucket_len=8), clock=clock)
    op.fleetautoscaler.attach_fleet("default", "svc", fleet)

    # ---- batch: the lane, its bridge and its gateway ---------------------
    lane_engine = ContinuousBatchingEngine(
        lane_cfg or cfg, params if lane_params is None else lane_params,
        n_slots=BROKER_LANE_SLOTS, max_len=FLEET_MAX_LEN, device=device)
    engines.append(lane_engine)
    gateway = ServingGateway(lane_engine, clock=clock)
    lane = BatchLane(slots_per_unit=BROKER_LANE_SLOTS, max_units=1)
    items, rids, results, current, cancelled = {}, {}, {}, {}, []

    class LaneGateway:
        """The gateway as the bridge sees it: each submission noted
        against the item the bridge rendered last, each result the bridge
        takes (``result`` pops it) kept, each cancel noted."""

        def submit(self, prompt, max_new_tokens, **kw):
            rid = gateway.submit(prompt, max_new_tokens, **kw)
            if not isinstance(rid, Rejected):
                rids[rid] = current["item"]
            return rid

        def result(self, rid):
            res = gateway.result(rid)
            if res is not None:
                results[rid] = res
            return res

        def cancel(self, rid):
            cancelled.append(rid)
            return gateway.cancel(rid)

    bridge = BatchGatewayBridge(lane, LaneGateway())
    brng = np.random.default_rng((seed, BROKER_LANE_STREAM))
    for _ in range(BROKER_LANE_ITEMS):
        n, new = int(brng.integers(64, 513)), int(brng.integers(16, 33))
        prompt = brng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        items[lane.submit(work=new)] = (prompt, new)

    def render(item):
        # the bridge reads max_new_tokens after rendering the prompt
        current["item"] = item.item_id
        bridge.max_new_tokens = items[item.item_id][1]
        return items[item.item_id][0]

    yields = []

    def lane_apply(target, reason):
        before = len(cancelled)
        ok = lane.apply(target, reason)
        n = bridge.yield_excess()
        yields.append((clock.t, reason, target, n, cancelled[before:]))
        return ok

    broker.register(lane.name, lane.bid, apply_fn=lane_apply, managed=True)

    # ---- the run ---------------------------------------------------------
    settle()
    rng = np.random.default_rng(seed)
    tokens_rng = np.random.default_rng((seed, FLEET_TOKEN_STREAM))
    reqs, rejected, transitions, step_ms, holdings = {}, 0, [], [], []
    ticks = {"n": 0}
    refusals = []
    step, tail = 0, FLEET_TAIL

    def holding():
        """The units each consumer holds: replicas, worker hosts, lane
        units (one 8-GPU host each)."""
        job = cluster.get(TorchJob, "default", "train")
        return {"serve": cluster.get(InferenceService, "default",
                                     "svc").spec.replicas,
                "train": job.spec.tasks[TaskType.WORKER].num_tasks,
                "batch": lane.granted}

    def tick():
        before = cluster.get(InferenceService, "default", "svc").spec.replicas
        op.fleetautoscaler.run_once()
        if op.fleetautoscaler.decision_log and \
                op.fleetautoscaler.decision_log[-1].endswith(
                    "patch_failed BrokerRefused"):
            refusals.append(clock.t)
        op.autoscaler.run_once()
        broker.run_once()
        svc = cluster.get(InferenceService, "default", "svc")
        if svc.spec.replicas != before:
            transitions.append((clock.t, before, svc.spec.replicas))
        ticks["n"] += 1
        op.run_once()
        sim.run_all("default")
        op.run_once()
        why = replica_pods_follow(
            cluster, cluster.get(InferenceService, "default", "svc"))
        if why:
            fail(f"tick {ticks['n']} (t {clock.t:.2f}): the replica pods do "
                 f"not follow spec.replicas: {why}")
        holdings.append((clock.t, holding()))

    while (step < 40 or fleet.has_live_requests or fleet.queue_depth
           or tail > 0 or lane.completed < lane.submitted):
        for prompt, new in burst_arrivals(step, rng, tokens_rng,
                                          cfg.vocab_size):
            r = fleet.submit(prompt, new)
            if isinstance(r, Rejected):
                rejected += 1
            else:
                reqs[r] = (prompt, new)
        t0 = time.perf_counter()
        fleet.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gateway.step()
        bridge.poll()
        bridge.pump(render)
        if not lane.intact():
            fail(f"fleet step {step}: the batch lane lost an item: "
                 f"{lane.snapshot()}")
        clock.advance(FLEET_DT)
        if step % 2 == 0:
            tick()
        if step >= 40 and not fleet.has_live_requests \
                and not fleet.queue_depth:
            tail -= 1
        step += 1
        if step > BROKER_MAX_STEPS:
            fail(f"phase 16: the market did not settle in {step} fleet "
                 f"steps: lane {lane.snapshot()}")
    return dict(op=op, cluster=cluster, broker=broker, fleet=fleet,
                scaler=op.fleetautoscaler, metrics=op.autoscale_metrics,
                transitions=transitions, reqs=reqs, rejected=rejected,
                results={rid: fleet.result(rid) for rid in reqs},
                engines=engines, steps=step, step_ms=step_ms, ticks=ticks,
                svc=cluster.get(InferenceService, "default", "svc"),
                lane=lane, gateway=gateway, items=items,
                lane_done={rids[rid]: (rid, res)
                           for rid, res in results.items()},
                yields=yields, holdings=holdings, refusals=refusals,
                order=order,
                expected=expected, held=held, admitted=admitted,
                pods_before=pods_before, rids_item=rids)


def broker_rungs(log) -> list:
    """The broker's decision log as (lane, action, reason), the steady
    holds left out."""
    out = []
    for line in log:
        f = dict(kv.split("=", 1) for kv in line.split() if "=" in kv)
        if "patch_failed" in line:
            out.append((f.get("lane"), "patch_failed", line.split()[-1]))
        elif f.get("reason") != "steady":
            out.append((f["lane"], f["action"], f["reason"]))
    return out


def market_gates(tag: str, env: dict) -> None:
    """Phase 16 (a)'s gates on one ``brokered_burst`` run (module
    docstring): the ladder, the batch lane, serving (``burst_gates``), the
    coordinator's admission and the training gang's pods."""
    from tpu_on_k8s_torch.api import constants
    from tpu_on_k8s_torch.api.core import Pod
    from tpu_on_k8s_torch.api.types import TaskType, TorchJob
    from tpu_on_k8s_torch.serve import RequestState

    serve, train = "serve/default/svc", "train/default/train"
    rungs = broker_rungs(env["broker"].decision_log)
    moved = [(lane, reason.split(":")[0]) for lane, action, reason in rungs
             if reason.split(":")[0] in ("degrade", "harvest", "preempt",
                                         "grant", "refuse", "fill")]
    first = {}
    for i, (lane, verb) in enumerate(moved):
        first.setdefault((lane, verb), i)
    want = [("batch", "harvest"), (train, "preempt"), (serve, "grant")]
    if not all(k in first for k in want) or [first[k] for k in want] != \
            sorted(first[k] for k in want):
        fail(f"{tag}: the ladder did not climb harvest -> preempt -> grant: "
             f"{rungs}")
    if any(verb in ("refuse", "degrade") for _, verb in moved):
        fail(f"{tag}: a refusal or a degrade in the market: {rungs}")
    if not any(lane == "batch" and verb == "fill"
               and i > first[(serve, "grant")]
               for i, (lane, verb) in enumerate(moved)):
        fail(f"{tag}: the batch lane was not filled again after the grant")
    trained = env["cluster"].get(TorchJob, "default", "train")
    hosts = trained.spec.tasks[TaskType.WORKER].num_tasks
    if not BROKER_TRAIN_MIN <= hosts < BROKER_TRAIN_HOSTS:
        fail(f"{tag}: the training gang ended at {hosts} hosts")
    # the refused scale-up burned no cooldown: the serving loop's next up
    # landed inside the cooldown a landed patch would have started
    if not env["refusals"]:
        fail(f"{tag}: no scale-up was refused by the broker")
    ups = [t for t, o, n in env["transitions"] if n > o]
    t_refused = env["refusals"][0]
    if not ups or ups[0] - t_refused >= FLEET_POLICY["scale_up_cooldown_s"]:
        fail(f"{tag}: the first scale-up landed at {ups[:1]} after the "
             f"refusal at {t_refused:.2f}: a cooldown was burned")
    # the batch lane lost nothing and finished
    lane, gateway = env["lane"], env["gateway"]
    snap = lane.snapshot()
    if (not lane.intact() or snap["completed"] != BROKER_LANE_ITEMS
            or snap["backlog"] or snap["in_flight"]):
        fail(f"{tag}: the batch lane ended {snap}")
    cancelled = [rid for *_, rids in env["yields"] for rid in rids]
    if not cancelled or snap["yields"] < len(cancelled):
        fail(f"{tag}: the harvest cancelled no gateway request: "
             f"{env['yields']}")
    states = {rid: gateway.state(rid) for rid in cancelled}
    if any(s is not RequestState.CANCELLED for s in states.values()):
        fail(f"{tag}: harvested gateway requests ended {states}")
    done = env["lane_done"]
    if sorted(done) != sorted(env["items"]) or any(
            res.state is not RequestState.DONE
            or len(res.tokens) != env["items"][iid][1]
            for iid, (_, res) in done.items()):
        fail(f"{tag}: batch items ended "
             f"{ {i: r.state.value for i, (_, r) in done.items()} }")
    # serving holds phase 15's gates
    burst_gates(tag, env, crash=False)
    # the coordinator admitted the jobs in smooth WRR's order
    if env["order"] != env["expected"]:
        fail(f"{tag}: dequeue order {env['order']}, smooth WRR's "
             f"{env['expected']}")
    for name in env["expected"]:
        if env["held"][name] != [("True", "JobEnqueued")] or \
                env["admitted"][name] != [("False", "JobDequeued")]:
            fail(f"{tag}: {name} went {env['held'][name]} -> "
                 f"{env['admitted'][name]}, not Queuing -> Dequeued")
    if env["pods_before"]:
        fail(f"{tag}: {env['pods_before']} pods before the coordinator "
             f"dequeued a job")
    need = {constants.ENV_PROCESS_ID, constants.ENV_NUM_PROCESSES,
            constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT}
    for name in env["expected"]:
        pods = env["cluster"].list(Pod, "default",
                                   {constants.LABEL_JOB_NAME: name})
        if not pods:
            fail(f"{tag}: job {name} has no pods")
        for pod in pods:
            [c] = pod.spec.containers
            names = [e.name for e in c.env] + list(pod.spec.node_selector)
            if (not need <= {e.name for e in c.env}
                    or c.resources.requests.get(constants.RESOURCE_GPU) != 8
                    or any("tpu" in n.lower() for n in names)):
                fail(f"{tag}: pod {pod.metadata.name} env {sorted(names)}, "
                     f"resources {c.resources.requests}")


def broker_grant_crash(cfg, params, device, dump_dir: Path) -> dict:
    """Phase 16 (b): ``tests/test_modelpool.py``'s
    ``test_broker_grant_under_replica_crash_keeps_both_domains_typed`` with
    two replica engines of ``cfg``/``params`` on ``device``: a
    ``CapacityBroker`` of 8 units with one managed batch lane (its bid
    wants 4), a ``ServingFleet`` of two replicas whose tracer rings its
    finished spans in a ``FlightRecorder`` dumping under ``dump_dir``, and
    BROKER_CRASH_REQUESTS requests (numpy seed 41, prompts 64-512 tokens,
    16 new) under ``broker_grant_under_crash("replica-1")``. The
    reference's assertions are this function's gates."""
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.coordinator.broker import (
        KIND_BATCH,
        PRIORITY_BATCH,
        Bid,
        CapacityBroker,
    )
    from tpu_on_k8s_torch.metrics import BrokerMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.obs import FlightRecorder, Tracer, to_chrome_trace
    from tpu_on_k8s_torch.obs.ledger import DecisionLedger, DecisionRecord
    from tpu_on_k8s_torch.serve import (
        ProbeConfig,
        RequestState,
        Router,
        ServingFleet,
    )

    class Lane:
        current = 0

        def __init__(self):
            self.applied = []

        def bid(self):
            return Bid(name="bat", kind=KIND_BATCH, priority=PRIORITY_BATCH,
                       current=self.current, desired=4, floor=0, unit=1)

        def apply(self, target, reason):
            self.applied.append((target, reason))
            self.current = target
            return True

    clock = FakeClock()
    led = DecisionLedger(clock)
    broker = CapacityBroker(8, ledger=led, metrics=BrokerMetrics())
    lane = Lane()
    broker.register("bat", lane.bid, apply_fn=lane.apply, managed=True)
    recorder = FlightRecorder(directory=str(dump_dir))
    tracer = Tracer(time.perf_counter, recorder=recorder)
    engines = []

    def factory(name):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=2,
                                       max_len=FLEET_MAX_LEN, device=device)
        engines.append(eng)
        return eng

    fleet = ServingFleet(factory, 2, probe=ProbeConfig(slow_start_steps=1),
                         router=Router(prefix_bucket_len=8), tracer=tracer)
    for _ in range(3):
        fleet.step()                          # both replicas ready
    rng = np.random.default_rng(41)
    reqs = {}
    for _ in range(BROKER_CRASH_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=int(
            rng.integers(64, 513))).astype(np.int32)
        reqs[fleet.submit(prompt, 16)] = (prompt, 16)
    inj = chaos.broker_grant_under_crash("replica-1").injector()
    with inj:
        broker.run_once()                     # grant #1 hits the stale bid
        if lane.applied or lane.current:
            fail(f"phase 16 (b): a partial apply: {lane.applied}")
        if not any("patch_failed StaleBidError" in ln
                   for ln in broker.decision_log):
            fail(f"phase 16 (b): no stale-bid rejection in "
                 f"{broker.decision_log}")
        if broker.metrics.counters[("lane_conflicts", "")] != 1:
            fail(f"phase 16 (b): lane conflicts {dict(broker.metrics.counters)}")
        for _ in range(3):
            fleet.step()                      # 3rd replica-1 step crashes
        if fleet.stats["ejected"] != 1:
            fail(f"phase 16 (b): {fleet.stats['ejected']} ejections")
        broker.run_once()                     # market re-clears, unmasked
        if lane.applied != [(4, "fill:idle_capacity")]:
            fail(f"phase 16 (b): the next clearing applied {lane.applied}")
        out = fleet.drain(timeout_s=120.0)
    states = {rid: res.state for rid, res in out.items()}
    if set(out) != set(reqs) or any(
            s not in (RequestState.DONE, RequestState.RETRY_EXHAUSTED)
            for s in states.values()) or not any(
            s is RequestState.DONE for s in states.values()):
        fail(f"phase 16 (b): requests ended {states}")
    conflicts = [r for r in led.records if isinstance(r, DecisionRecord)
                 and r.commit == "conflict:StaleBidError"]
    if not conflicts or not conflicts[0].trigger.startswith("chaos#"):
        fail(f"phase 16 (b): the ledger's conflict {conflicts}")
    doc = json.loads(json.dumps(to_chrome_trace(tracer.spans)))
    finished = [s for s in tracer.export() if s["end"] is not None]
    if sum(e["ph"] == "X" for e in doc["traceEvents"]) != len(finished):
        fail("phase 16 (b): the Chrome trace's complete events are not the "
             "finished spans")
    if [Path(p).name for p in recorder.dumps] != [
            "flightrec-0001-replica_ejected.json"]:
        fail(f"phase 16 (b): flight-recorder dumps {recorder.dumps}")
    return dict(fleet=fleet, engines=engines, broker=broker, ledger=led,
                reqs=reqs, out=out, chaos=list(inj.events),
                dumps=list(recorder.dumps), trace=doc, spans=len(finished))


def broker_phase(mods, gpu, dev, plain_flash, transformer, decode, convert,
                 diff, tmp: Path) -> dict:
    """Phase 16: the capacity market (``coordinator/broker.py``,
    ``serve/batchlane.py``, ``coordinator/core.py``, ``main.py``) over
    gpt2_small on the card (module docstring). (a) ``brokered_burst`` at
    gpt2_small's full width and depth in bf16 (phase 6's tree, from its
    torch seed), its decision logs (the broker's, the fleet autoscaler's,
    the elastic autoscaler's) byte-identical to the same driver's at the
    ``tiny`` config on the CPU (gpt2_small's vocabulary, as phase 15's
    twin), ``market_gates`` on both runs, the serving tokens through phase
    6 (c)'s teacher-forced gate, and each batch item's tokens equal to a
    solo greedy ``generate`` of its prompt on the card. (b)
    ``broker_grant_crash`` on two gpt2_small replicas. The flash launches
    of (a) and (b) are the path ``broker``. Returns the launches by
    path."""
    from tpu_on_k8s_torch.models.params import init_params, keeps_fp32
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    t_phase = time.perf_counter()
    lane_cfg, lane_params = gpt2_small_tree(convert, init_params, dev)
    cfg = dataclasses.replace(lane_cfg, dtype=torch.bfloat16)
    bparams = {n: t if keeps_fp32(n) else t.to(torch.bfloat16)
               for n, t in lane_params.items()}
    twin_cfg = dataclasses.replace(
        TransformerConfig.tiny(), max_seq_len=FLEET_MAX_LEN,
        vocab_size=cfg.vocab_size, dtype=torch.float32)
    twin = init_params(twin_cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)

    t0 = time.perf_counter()
    cpu = brokered_burst(twin_cfg, twin, "cpu", seed=FLEET_SEED)
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts(mods)
    t0 = time.perf_counter()
    env = brokered_burst(cfg, bparams, dev, seed=FLEET_SEED,
                         lane_cfg=lane_cfg, lane_params=lane_params)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launched_a = read_counts(mods)
    fresh = sum(e.stats["fresh_prefills"] for e in env["engines"])
    loops = (("broker", lambda e: e["broker"].decision_log),
             ("fleet autoscaler", lambda e: e["scaler"].decision_log),
             ("elastic autoscaler", lambda e: e["op"].autoscaler.decision_log))
    for name, log_of in loops:
        mine, twins = list(log_of(env)), list(log_of(cpu))
        same = "\n".join(mine).encode() == "\n".join(twins).encode()
        print(f"[broker] (a) {name} decision log {len(mine)} lines, byte-"
              f"identical to the CPU twin's: {same}")
        if not same:
            at = next((i for i, (x, y) in enumerate(zip(mine, twins))
                       if x != y), min(len(mine), len(twins)))
            fail(f"phase 16 (a) {name} decision log differs from the CPU "
                 f"twin's at line {at}: {mine[at:at + 1]} / "
                 f"{twins[at:at + 1]}")
    rungs = broker_rungs(env["broker"].decision_log)
    when = {}
    for t, held in env["holdings"]:
        when.setdefault(tuple(sorted(held.items())), t)
    print(f"[broker] (a) the market of {BROKER_CAPACITY} hosts: rungs "
          f"(lane, action, reason) {rungs}")
    print(f"[broker] (a) holdings (virtual s -> serve, train, batch hosts) "
          f"{[(round(t, 2), dict(h)) for h, t in when.items()]}; "
          f"before {env['holdings'][0][1]}, after {env['holdings'][-1][1]}")
    yielded = sorted({env["rids_item"][rid] for *_, rids in env["yields"]
                      for rid in rids})
    print(f"[broker] (a) batch lane {env['lane'].snapshot()}: harvests "
          f"{[(round(t, 2), r, tgt, n) for t, r, tgt, n, _ in env['yields']]}"
          f"; items yielded then completed {yielded}; coordinator dequeue "
          f"order {env['order']} (smooth WRR's {env['expected']})")
    print(f"[broker] (a) serving transitions (virtual s, from, to) "
          f"{[(round(t, 2), o, n) for t, o, n in env['transitions']]}, "
          f"refused scale-ups at {[round(t, 2) for t in env['refusals']]}; "
          f"{len(env['reqs'])} requests {dict(Counter(r.state.value for r in env['results'].values()))}; "
          f"launches {launched_a} = {cfg.n_layers} x {fresh} fresh prefills "
          f"on {len(env['engines'])} engines")
    print(f"[time] {gpu}: phase 16 (a) gpt2_small bf16: {env['steps']} fleet "
          f"steps in {wall_a:.2f} s, host ms a fleet step median "
          f"{statistics.median(env['step_ms']):.2f} (max "
          f"{max(env['step_ms']):.2f}); the CPU twin {cpu_s:.2f} s")
    if launched_a["flash_fwd"] != cfg.n_layers * fresh or not fresh or any(
            c for k, c in launched_a.items() if k != "flash_fwd"):
        fail(f"phase 16 (a) launches {launched_a} for {fresh} fresh "
             f"prefills")
    market_gates("phase 16 (a)", env)
    market_gates("phase 16 (a) CPU twin", cpu)
    if yielded != sorted({cpu["rids_item"][rid] for *_, rids in cpu["yields"]
                          for rid in rids}):
        fail("phase 16 (a): the card and its twin yielded other items")
    del cpu
    # the batch items against a solo greedy generate of each prompt (the
    # lane's fp32 engine: see BROKER_* above)
    differ = []
    for iid, (prompt, new) in sorted(env["items"].items()):
        solo = decode.generate(lane_cfg, lane_params,
                               torch.from_numpy(prompt)[None], new,
                               device=dev)
        got = np.asarray(env["lane_done"][iid][1].tokens)
        if not np.array_equal(solo.cpu().numpy()[0], got):
            differ.append(iid)
    print(f"[broker] (a) batch items equal to a solo greedy generate on "
          f"the card: {BROKER_LANE_ITEMS - len(differ)} of "
          f"{BROKER_LANE_ITEMS} (the yielded {yielded} among them); "
          f"differ {differ}")
    if differ:
        fail(f"phase 16 (a): batch items {differ} differ from a solo "
             f"greedy generate")
    model = decode.decode_model(cfg, bparams, dev)
    done = [rid for rid, r in env["results"].items()
            if r.state.value == "done"]
    gaps = teacher_forced_gaps(
        model, [env["reqs"][rid] for rid in done],
        {j: np.asarray(env["results"][rid].tokens)
         for j, rid in enumerate(done)}, None, set(), plain_flash,
        transformer, decode)
    tau_gate("[broker] (a)", gaps, GPT2_TAU_MULT * diff, diff,
             mult=GPT2_TAU_MULT, exact_min=GPT2_EXACT_MIN,
             unit="phase 6 (b)'s")
    del env, model, gaps

    torch.cuda.synchronize()
    reset_counts(mods)
    t0 = time.perf_counter()
    crash = broker_grant_crash(cfg, bparams, dev, tmp / "flightrec")
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launched_b = read_counts(mods)
    fresh = sum(e.stats["fresh_prefills"] for e in crash["engines"])
    print(f"[broker] (b) broker_grant_under_crash(replica-1) on two "
          f"gpt2_small replicas: chaos {crash['chaos']}; broker log "
          f"{[r for r in broker_rungs(crash['broker'].decision_log)]}; "
          f"ejected {crash['fleet'].stats['ejected']}; requests "
          f"{ {rid: r.state.value for rid, r in crash['out'].items()} }; "
          f"flight-recorder dumps {[Path(p).name for p in crash['dumps']]};"
          f" Chrome trace {len(crash['trace']['traceEvents'])} events, "
          f"{crash['spans']} complete spans; launches {launched_b} = "
          f"{cfg.n_layers} x {fresh} fresh prefills; {wall_b:.2f} s")
    if launched_b["flash_fwd"] != cfg.n_layers * fresh or not fresh:
        fail(f"phase 16 (b) launches {launched_b} for {fresh} fresh "
             f"prefills")
    del crash, bparams, lane_params
    torch.cuda.empty_cache()
    launched = {k: launched_a[k] + launched_b[k] for k in launched_a}
    print(f"[broker] flash launches, path broker: {launched['flash_fwd']}; "
          f"{gpu}")
    print(f"[time] phase 16 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": {"broker": launched}}


def load_phase(mods, gpu, tmp: Path) -> dict:
    """Phase 17: the load driver (``serve_load.py``) on the card (module
    docstring): (a) the gateway under wall-clock arrivals, (b) the traced
    disaggregated fleet and its control arm, both through
    ``serve_load.main`` on ``cuda``, each engine and gateway it builds
    recorded to read their prefill counts and histograms. Returns the
    launches by path."""
    import contextlib
    import io

    from tpu_on_k8s_torch import serve_load
    from tpu_on_k8s_torch.models import serving
    from tpu_on_k8s_torch.obs.export import load_trace
    from tpu_on_k8s_torch.obs.trace_report import SEGMENTS, build_report
    from tpu_on_k8s_torch.serve import gateway as gateway_mod

    t_phase = time.perf_counter()
    n_layers = serve_load.bench_config().n_layers
    engines, gateways, arms = [], [], []

    def recorder(cls, store):
        init = cls.__init__

        def recorded(self, *args, **kw):
            init(self, *args, **kw)
            store.append(self)
        return mock.patch.object(cls, "__init__", recorded)

    run_disagg = serve_load.run_disagg_trace

    def run_arm(*args, **kw):
        first = len(engines)
        out = run_disagg(*args, **kw)
        arms.append(("disagg" if kw.get("disagg", True) else "control",
                     engines[first:]))
        return out

    def drive(argv):
        engines.clear()
        gateways.clear()
        torch.cuda.synchronize()
        reset_counts(mods)
        t0 = time.perf_counter()
        with recorder(serving.ContinuousBatchingEngine, engines), \
                recorder(gateway_mod.ServingGateway, gateways), \
                mock.patch.object(serve_load, "run_disagg_trace", run_arm), \
                contextlib.redirect_stdout(io.StringIO()) as out:
            summary = serve_load.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if json.loads(out.getvalue().splitlines()[-1]) != json.loads(
                json.dumps(summary)):
            fail(f"phase 17: {argv} printed another summary than it "
                 f"returned")
        return summary, read_counts(mods), wall

    def pctl(hist, q):
        return serve_load._pctl(list(hist), q)

    # (a) the gateway under wall-clock arrivals
    a, launched_a, wall_a = drive(LOAD_TTFT_ARGV)
    fresh_a = sum(e.stats["fresh_prefills"] for e in engines)
    hist = gateways[0].metrics.histograms
    accounted = (a["served"] + a["rejected"] + a["deadline_exceeded"]
                 + a["cancelled"])
    print(f"[load] (a) serve_load {' '.join(LOAD_TTFT_ARGV)}: {accounted} "
          f"of {a['requests']} accounted ({a['served']} served, "
          f"{a['rejected']} rejected, {a['deadline_exceeded']} expired, "
          f"{a['cancelled']} cancelled), {a['tokens']} tokens in "
          f"{a['driver_steps']} driver steps, {a['value']} tokens/s over "
          f"{a['wall_s']} s; launches {launched_a} = {n_layers} x "
          f"{fresh_a} fresh prefills (warm-up included) on "
          f"{len(engines)} engine")
    print(f"[load] (a) {gpu}: TTFT ms p50 {a['ttft_ms_p50']} p95 "
          f"{pctl(hist['time_to_first_token_seconds'], 0.95)} p99 "
          f"{a['ttft_ms_p99']}; TPOT ms p50 {a['tpot_ms_p50']} p95 "
          f"{pctl(hist['time_per_output_token_seconds'], 0.95)} p99 "
          f"{a['tpot_ms_p99']}; queue wait ms p50 {a['queue_wait_ms_p50']} "
          f"p95 {pctl(hist['queue_wait_seconds'], 0.95)} p99 "
          f"{a['queue_wait_ms_p99']}; phase 17 (a) {wall_a:.2f} s")
    if accounted != 48 or a["requests"] != 48:
        fail(f"phase 17 (a): {accounted} of 48 requests accounted for")
    if not a["tokens"] > 0:
        fail("phase 17 (a): no tokens")
    if a["ttft_ms_p50"] is None or a["queue_wait_ms_p50"] is None:
        fail(f"phase 17 (a): TTFT p50 {a['ttft_ms_p50']}, queue wait p50 "
             f"{a['queue_wait_ms_p50']}")
    if len(engines) != 1 or not fresh_a or \
            launched_a["flash_fwd"] != n_layers * fresh_a:
        fail(f"phase 17 (a): launches {launched_a} for {fresh_a} fresh "
             f"prefills on {len(engines)} engines")

    # (b) the traced disaggregated fleet and its monolithic control arm
    dump = tmp / "load_trace.json"
    b, launched_b, wall_b = drive(LOAD_TRACE_ARGV + ["--trace-out",
                                                     str(dump)])
    report = build_report(load_trace(str(dump)))
    accounted = (b["served"] + b["rejected"] + b["deadline_exceeded"]
                 + b["cancelled"] + b["retry_exhausted"])
    fresh = {arm: [e.stats["fresh_prefills"] for e in engs]
             for arm, engs in arms}
    cp = b["ttft_critical_path"]
    print(f"[load] (b) serve_load {' '.join(LOAD_TRACE_ARGV)} --trace-out: "
          f"disagg {accounted} of {b['requests']} accounted "
          f"({b['served']} served), {b['tokens']} tokens in "
          f"{b['driver_steps']} steps; handoffs {b['handoffs_adopted']} of "
          f"{b['handoffs_enqueued']} adopted, {b['handoffs_lost']} lost, "
          f"{b['handoffs_corrupt']} corrupt; prefix store "
          f"{b['prefix_store']}; decode TPOT cost p50/p95 "
          f"{b['decode_tpot_cost_p50']}/{b['decode_tpot_cost_p95']} against "
          f"the control's {b['control']['decode_tpot_cost_p50']}/"
          f"{b['control']['decode_tpot_cost_p95']}; prefix recompute "
          f"{b['prefix_prefill_recompute']} against "
          f"{b['control']['prefix_prefill_recompute']}; per pool "
          f"{b['per_pool']}")
    print(f"[load] (b) the trace: {report['spans']} spans "
          f"{report['span_names']}; {report['requests']} requests, "
          f"{report['decomposed']} decomposed, {report['no_token']} without "
          f"a token; fresh prefills by arm and engine {fresh}; launches "
          f"{launched_b}")
    print(f"[load] (b) {gpu}: TTFT critical path (virtual ms) p50 "
          f"{cp['ttft_ms_p50']} p95 {cp['ttft_ms_p95']}; " + "; ".join(
              f"{n} p50 {cp['segments'][n]['p50_ms']} p95 "
              f"{cp['segments'][n]['p95_ms']} share "
              f"{cp['segments'][n]['share']}" for n in SEGMENTS)
          + f"; residual max {cp['residual_ms_max']} ms; phase 17 (b) "
          f"{wall_b:.2f} s")
    if accounted != 48 or b["requests"] != 48:
        fail(f"phase 17 (b): the disagg arm accounts for {accounted} of 48")
    if report["decomposed"] + report["no_token"] != 48:
        fail(f"phase 17 (b): the trace decomposes {report['decomposed']} "
             f"and marks {report['no_token']} of 48 requests")
    if not LOAD_SPANS <= set(report["span_names"]):
        fail(f"phase 17 (b): spans {sorted(report['span_names'])} lack "
             f"{sorted(LOAD_SPANS - set(report['span_names']))}")
    if [arm for arm, _ in arms] != ["control", "disagg"] or any(
            not sum(f) for f in fresh.values()) or \
            launched_b["flash_fwd"] != n_layers * sum(map(sum,
                                                          fresh.values())):
        fail(f"phase 17 (b): launches {launched_b} for fresh prefills "
             f"{fresh} by arm")
    engines.clear()
    gateways.clear()
    arms.clear()
    torch.cuda.empty_cache()
    launched = {k: launched_a[k] + launched_b[k] for k in launched_a}
    print(f"[load] flash launches, path load: {launched['flash_fwd']} "
          f"({launched_a['flash_fwd']} + {launched_b['flash_fwd']}); {gpu}")
    print(f"[time] phase 17 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": {"load": launched}}


def twin_measure(cfg, host_params, device, *, slots=FLEET_SLOTS,
                 max_len=FLEET_MAX_LEN, starts=TWIN_STARTS,
                 decode_prompt=TWIN_DECODE_PROMPT, decode_new=TWIN_DECODE_NEW,
                 min_steps=TWIN_MIN_STEPS, prefill_lens=TWIN_PREFILL_LENS,
                 reps=TWIN_PREFILL_REPS, seed=TWIN_SEED) -> dict:
    """Phase 18 (a): the samples the cost model's constants are fitted
    from, each ended by a synchronize on a card (module constants): replica
    starts from ``host_params`` (a tree on the host), decode steps at full
    occupancy, single-request prefills. Returns them in the shape
    ``sim/calibrate`` reads, with the engines' fresh prefills."""
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine

    rng = np.random.default_rng(seed)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    engines, compiles = [], []
    for _ in range(starts):
        sync()
        t0 = time.perf_counter()
        params = {n: t.to(device) for n, t in host_params.items()}
        eng = ContinuousBatchingEngine(cfg, params, n_slots=slots,
                                       max_len=max_len, device=device)
        eng.submit(prompt(decode_prompt), 1)
        eng.step()
        sync()
        compiles.append(time.perf_counter() - t0)
        engines.append(eng)
    # decode: one step admits every slot; then each step at occupancy
    # ``slots`` (counted before it runs) is a sample
    for _ in range(slots):
        eng.submit(prompt(decode_prompt), decode_new)
    eng.step()
    steps = []
    while sum(s is not None for s in eng._slots) == slots:
        sync()
        t0 = time.perf_counter()
        eng.step()
        sync()
        steps.append(time.perf_counter() - t0)
    eng.run()
    if len(steps) < min_steps:
        fail(f"phase 18 (a): {len(steps)} decode steps at occupancy "
             f"{slots}, fewer than {min_steps}")
    prefills = []
    for rep in range(reps + 1):
        for n in prefill_lens:
            sync()
            t0 = time.perf_counter()
            eng.submit(prompt(n), 1)
            eng.step()
            sync()
            if rep:                 # the first pass warms every bucket
                prefills.append([n, time.perf_counter() - t0])
    fresh = sum(e.stats["fresh_prefills"] for e in engines)
    del engines, eng, params
    return {"decode_steps": steps, "compiles": compiles,
            "prefills": prefills, "fresh_prefills": fresh}


def twin_priced(doc: Path, tmp: Path, scenario_name=TWIN_SCENARIO) -> dict:
    """Phase 18 (b) and (c), device-free: ``sim/calibrate``'s CLI fits
    ``doc`` (``--strict``), its document round-trips, and the preset runs
    twice through the port's twin on the fitted costs, run A with
    ``time.perf_counter`` as its wall clock. Gates: all three constants
    fitted, the four artifacts byte-identical, the summary's accounting
    closed (``tests/test_sim.py``'s), the fuzz driver's report gate passing
    (``why_report`` and ``slo_report`` only on a run that paged, as the
    reference's gate). The oracle's verdict and the story are read, not
    gated: a card faster than the defaults may never page."""
    import contextlib
    import io

    from tpu_on_k8s_torch import fuzz_run, metrics
    from tpu_on_k8s_torch.sim import calibrate, scenario, twin
    from tpu_on_k8s_torch.sim.fuzz import OracleConfig, judge_run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main([str(doc), "--strict"])
    if rc != 0:
        fail(f"phase 18 (b): calibrate --strict exited {rc}")
    cal = calibrate.calibration_from_doc(json.loads(out.getvalue()))
    if cal.fitted != TWIN_FITTED:
        fail(f"phase 18 (b): fitted {cal.fitted}, not {TWIN_FITTED}")
    if calibrate.calibration_from_doc(cal.to_doc()) != cal:
        fail("phase 18 (b): the calibration does not round-trip its doc")
    base = scenario.preset(scenario_name)
    sc = dataclasses.replace(base, cost=cal.cost_model(base.cost))
    dir_a, dir_b = tmp / "twin_a", tmp / "twin_b"
    run_a = twin.DigitalTwin(sc, wall_clock=time.perf_counter)
    summary = run_a.run()
    run_a.write(str(dir_a))
    twin.run_twin(sc, str(dir_b))
    artifacts = (twin.TRACE_FILE, twin.LEDGER_FILE, twin.SLO_FILE,
                 twin.SUMMARY_FILE)
    differ = [f for f in artifacts
              if (dir_a / f).read_bytes() != (dir_b / f).read_bytes()]
    if differ:
        fail(f"phase 18 (c): {differ} differ between two runs")
    if not (summary["served"] == summary["requests"] > 1000
            and summary["rejected"] == 0 and summary["spans_dropped"] == 0):
        fail(f"phase 18 (c): accounting {summary['requests']} requests, "
             f"{summary['served']} served, {summary['rejected']} rejected, "
             f"{summary['spans_dropped']} spans dropped")
    gates = fuzz_run.report_gate(str(dir_a), summary["pages"])
    if any(rc for _, rc in gates):
        fail(f"phase 18 (c): report gate {gates}")
    verdict = judge_run(run_a, None, OracleConfig())
    return {"cal": cal, "base": base.cost, "summary": summary,
            "perf": run_a.perf, "gates": gates, "verdict": verdict,
            "exposition": metrics.exposition(run_a.sim_metrics)}


def twin_phase(mods, gpu, dev, convert, tmp: Path) -> dict:
    """Phase 18: the digital twin priced by the card (module docstring).
    (a) ``twin_measure`` on phase 15's gpt2_small replica engine, its flash
    launches the path ``twin``: 12 a fresh prefill; (b) the samples
    written as one measurement document with the card's name and power
    limit, fitted by ``sim/calibrate``; (c) ``twin_priced``. Returns the
    launches by path."""
    from tpu_on_k8s_torch.models.params import init_params, keeps_fp32

    t_phase = time.perf_counter()
    hcfg, params = gpt2_small_tree(convert, init_params, dev)
    cfg = dataclasses.replace(hcfg, dtype=torch.bfloat16)
    host = {n: (t if keeps_fp32(n) else t.to(torch.bfloat16)).cpu()
            for n, t in params.items()}
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts(mods)
    t0 = time.perf_counter()
    m = twin_measure(cfg, host, dev)
    torch.cuda.synchronize()
    measure_s = time.perf_counter() - t0
    launched = read_counts(mods)
    torch.cuda.empty_cache()
    fresh = m.pop("fresh_prefills")
    steps_ms = [1e3 * x for x in m["decode_steps"]]
    print(f"[twin] (a) gpt2_small bf16, {FLEET_SLOTS} slots x "
          f"{FLEET_MAX_LEN}: replica starts (weights host -> card, engine "
          f"set-up, first step; the port compiles nothing at start) "
          f"{[round(x, 4) for x in m['compiles']]} s; {len(steps_ms)} "
          f"decode steps at occupancy {FLEET_SLOTS}: median "
          f"{statistics.median(steps_ms):.3f} ms (min {min(steps_ms):.3f}, "
          f"max {max(steps_ms):.3f}); prefills (prompt, ms) "
          f"{[(n, round(1e3 * s, 3)) for n, s in m['prefills']]}; "
          f"{measure_s:.1f} s; {gpu}")
    if (launched["flash_fwd"] != cfg.n_layers * fresh or not fresh
            or any(c for k, c in launched.items() if k != "flash_fwd")):
        fail(f"phase 18 (a) launches {launched} for {fresh} fresh prefills")
    print(f"[twin] (d) flash launches, path twin: {launched['flash_fwd']} = "
          f"{cfg.n_layers} x {fresh} fresh prefills")
    name, _, limit = gpu.partition(", ")
    doc = tmp / "twin_measurements.json"
    doc.write_text(json.dumps({
        "card": name, "power_limit": limit,
        "engine": f"gpt2_small bf16, {FLEET_SLOTS} slots x {FLEET_MAX_LEN}",
        "twin_engine": m}, indent=1))
    res = twin_priced(doc, tmp)
    cal, base, s = res["cal"], res["base"], res["summary"]
    print(f"[twin] (b) fitted from the card ({gpu}): step_s {cal.step_s} "
          f"(default {base.step_s}), prefill_cost {cal.prefill_cost} "
          f"(default {base.prefill_cost}), compile_s {cal.compile_s} "
          f"(default {base.compile_s}); from {cal.n_steps} steps, "
          f"{cal.n_prefills} prefill fits, {cal.n_compiles} starts")
    print(f"[twin] (c) {TWIN_SCENARIO} on the card's costs, twice, 4 "
          f"artifacts byte-identical: requests {s['requests']}, served "
          f"{s['served']}, rejected {s['rejected']}, pages {s['pages']}, "
          f"budget transitions {s['budget_transitions']}, scale_ups "
          f"{s['scale_ups']}, scale_downs {s['scale_downs']}, preemptions "
          f"{s['preemptions']}, final replicas {s['final_replicas']}, train "
          f"workers {s.get('train_final_workers')}; report gate "
          f"{res['gates']}; oracle kinds {list(res['verdict'].kinds)}; "
          f"virtual {s['virtual_s']} s in {res['perf']['wall_s']} s wall, "
          f"speedup {res['perf']['speedup']}x")
    for line in res["exposition"].splitlines():
        if line.startswith("tpu_on_k8s_sim_") and "_created" not in line:
            print(f"[twin] (c) {line}")
    print(f"[time] phase 18 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": {"twin": launched}}

# Phase 19, the drivers of tools/ on the card: (a) chaos_soak's seed; (b)
# reshard_soak's seed and the reference's figures for it (the cost model's
# race, the same on any machine); (d) perf_sweep's two variants, the
# runbook's control (the reference's tools/chip_window.py CONTROL) and the
# same on the int8 GEMM kernel, SWEEP_STEPS timed steps each after its 3
# warm-up steps; (e) step_breakdown's calls a part; (f) the long-context
# lengths and (B, H, D) of longcontext_proof's model (its kv heads repeated
# to H on the training path; also checked at its 8 kv heads).
CHAOS_SEED = 1234
RESHARD_SEED = 6172
RESHARD_FIGURES = {"events_crc": "23b9ae46", "pause_win_s": 357.328755,
                   "goodput_win": 0.790586,
                   "live": {"pause_s": 4.332189, "goodput_fraction": 0.857875},
                   "restart": {"pause_s": 361.660944,
                               "goodput_fraction": 0.067289}}
SWEEP_CONTROL = ("attn=flash,remat=mlp,unroll=16,int8=1,gateup=1,nu=bf16,"
                 "batch=12")
SWEEP_VARIANTS = (SWEEP_CONTROL, SWEEP_CONTROL + ",i8impl=pallas")
SWEEP_STEPS, BREAKDOWN_STEPS = 5, 5
LONG_LENGTHS, LONG_SHAPE = (4096, 4000), (2, 16, 64)
# (c) attn_micro's default [B] [L] [H] [D], passed as its arguments
ATTN_MICRO_SHAPE = (12, 1024, 16, 64)


def long_kernels(fa, gpu, dev) -> dict:
    """Phase 19 (f): the three flash kernels at longcontext_proof's shapes,
    L 4096 and the ragged 4000 (past phase 2's tile edges, which stop at
    2047), B 2, H 16, D 64, bf16, causal, with k/v at 16 heads (the
    training path repeats them) and at 8: each held against its plain twin
    within phase 2's tolerances (``TOL``, ``BWD_REL_TOL``) and launched
    twice on the same inputs, bit for bit; then timed at the training
    path's heads (kernels: a CUDA graph of 20 calls, median of 7; plain
    twins: a graph of 5, median of 3) beside SDPA's forward and backward
    and the bound. Returns ``{"errs": {kernel: max|err|}, "rows": {kernel:
    {length: row}}}``."""
    gen = torch.Generator(device=dev).manual_seed(19)
    b, h, d = LONG_SHAPE
    tol_o, tol_lse = TOL[torch.bfloat16]
    tol_bwd = BWD_REL_TOL[torch.bfloat16]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    misses = []
    for l in LONG_LENGTHS:
        for hkv in (h, h // 2):
            q, k, v, do = (randn(b, n, l, d) for n in (h, hkv, hkv, h))
            o, lse = fa.flash_with_lse_fwd(q, k, v, True)
            o2, lse2 = fa.flash_with_lse_fwd(q, k, v, True)
            delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
            grads = (fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True))
            again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True))
            same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                    and all(map(torch.equal, grads, again)))
            del o2, lse2, again
            po, plse = fa.flash_attention_plain(q, k, v, True)
            err_o = (o.float() - po.float()).abs().max().item()
            err_lse = (lse - plse).abs().max().item()
            del po, plse
            rels = []
            for key, got, plain_fn in (
                    ("flash_bwd_dq", grads[:1], fa.flash_bwd_dq_plain),
                    ("flash_bwd_dkv", grads[1:], fa.flash_bwd_dkv_plain)):
                want = plain_fn(q, k, v, do, lse, delta, True)
                for g, w in zip(got, (want,) if len(got) == 1 else want):
                    err = (g.float() - w.float()).abs().max().item()
                    rels.append(err / w.float().abs().max().item())
                    errs[key] = max(errs[key], err)
                del want
                torch.cuda.empty_cache()
            errs["flash_fwd"] = max(errs["flash_fwd"], err_o)
            ok = (err_o <= tol_o and err_lse <= tol_lse
                  and max(rels) <= tol_bwd and same
                  and bool(torch.isfinite(o).all())
                  and all(bool(torch.isfinite(g).all()) for g in grads))
            label = (f"B={b} H={h} Hkv={hkv} L={l} D={d} bf16 causal")
            print(f"[tools] (f) flash_fwd + flash_bwd_dq + flash_bwd_dkv "
                  f"{label}: max|o-plain| {err_o:.3e} max|lse-plain| "
                  f"{err_lse:.3e} rel dq {rels[0]:.2e} dk {rels[1]:.2e} dv "
                  f"{rels[2]:.2e} (tols {tol_o:g}, {tol_lse:g}, "
                  f"{tol_bwd:g}); two launches bit-identical {same} "
                  f"{'ok' if ok else 'MISS'}")
            if not ok:
                misses.append(label)
            del q, k, v, do, o, lse, delta, grads
            torch.cuda.empty_cache()
    if misses:
        fail(f"the flash kernels disagree with their plain twins at the "
             f"long-context shapes: {misses}")

    rows = {name: {} for name in errs}
    for l in LONG_LENGTHS:
        q, k, v, do = (randn(b, h, l, d) for _ in range(4))
        o, lse = fa.flash_with_lse_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        sdpa_fwd = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        fn, stream = sdpa_backward(q, k, v, do, is_causal=True)
        sdpa_bwd = time_ms(fn, stream=stream)
        del fn
        timed = {
            "flash_fwd": (
                lambda: fa.flash_with_lse_fwd(q, k, v, True),
                lambda: fa.flash_attention_plain(q, k, v, True),
                flash_bound_ms(b, h, h, l, d, True), sdpa_fwd),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
                dq_bound_ms(b, h, h, l, d, True), sdpa_bwd),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               True),
                dkv_bound_ms(b, h, h, l, d, True), sdpa_bwd)}
        for name, (kernel, plain, (bound, by), lib) in timed.items():
            ms = time_ms(kernel)
            plain_ms = plain_time_ms(plain)
            torch.cuda.empty_cache()
            rows[name][str(l)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib, max_abs_err=errs[name],
                shape=f"B={b} H={h} Hkv={h} L={l} D={d} bf16 causal")
            print(f"[time] {gpu}: {name} B={b} H={h} L={l} D={d} bf16 "
                  f"causal (longcontext): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"{bound / ms:.1%} of bound; sdpa "
                  f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
                  f" {lib:.4f} ms")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return {"errs": errs, "rows": rows}


def tools_phase(mods, gpu, dev, fa, tmp: Path) -> dict:
    """Phase 19: the drivers of ``tools/`` that the port carries, on the
    card (module docstring). Returns the launches by path and the flash
    kernels' rows at the long-context shapes."""
    import contextlib
    import io

    import torch.distributed as dist

    from tpu_on_k8s_torch import (
        attn_micro,
        chaos_soak,
        driver_bench,
        longcontext_proof,
        perf_sweep,
        reshard_soak,
        step_breakdown,
    )
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.partition import (
        PartitionRule,
        shard_pytree,
    )
    from tpu_on_k8s_torch.train.distributed import initialize

    paths = {}
    t_phase = time.perf_counter()

    # ---- (a) chaos_soak, twice on the card, once on the CPU --------------
    t0 = time.perf_counter()
    ccfg = dataclasses.replace(TransformerConfig.gpt2_small(),
                               dtype=torch.float32, max_seq_len=64)
    cparams = init_params(ccfg, torch.Generator(device=dev).manual_seed(1),
                          dev)
    reset_counts(mods)
    runs = [chaos_soak.run_all(CHAOS_SEED, device=dev, cfg=ccfg,
                               params=cparams) for _ in range(2)]
    torch.cuda.synchronize()
    paths["chaos"] = read_counts(mods)
    del cparams
    torch.cuda.empty_cache()
    first = runs[0]
    cpu = chaos_soak.run_all(CHAOS_SEED, skip_operator=True, device="cpu")

    def crc_free(lines):
        return [ln.rsplit(" losses_crc=", 1)[0] for ln in lines]

    tail = first["events"][-len(cpu["events"]):]
    for line in first["events"]:
        print(f"[tools] (a) event: {line}")
    print(f"[tools] (a) chaos_soak.run_all({CHAOS_SEED}) twice on {dev} "
          f"(serve stage: gpt2_small fp32, {ccfg.n_layers} layers, d_model "
          f"{ccfg.d_model}, vocab {ccfg.vocab_size}, max_seq_len 64): "
          f"operator {first['operator']}, serve {first['serve']}, train "
          f"{first['train']}, events_crc {first['events_crc']} / "
          f"{runs[1]['events_crc']}; launches {paths['chaos']}; the CPU run "
          f"at tiny (no operator stage: it touches no device) events_crc "
          f"{cpu['events_crc']}, train {cpu['train']}; "
          f"{time.perf_counter() - t0:.1f} s")
    if (first["operator"]["replaced"] != 4 or first["serve"]["done"] != 6
            or first["serve"]["retry_exhausted_storm"] != 2
            or first["train"]["steps"] != 14
            or runs[1]["events"] != first["events"]
            or not any("oracle_exact=6" in e for e in first["events"])):
        fail(f"phase 19 (a) chaos soak gates: {first}")
    if crc_free(tail) != crc_free(cpu["events"]):
        fail(f"phase 19 (a) the CPU run's event lines differ from the "
             f"card's: {cpu['events']} vs {tail}")
    if (not paths["chaos"]["flash_fwd"]
            or any(c for k, c in paths["chaos"].items() if k != "flash_fwd")):
        fail(f"phase 19 (a) launches {paths['chaos']}")
    print(f"[tools] (a) the CPU run's event lines equal the card's (the "
          f"train line but losses_crc: card {first['train']['losses_crc']}, "
          f"CPU {cpu['train']['losses_crc']}, equal "
          f"{first['train']['losses_crc'] == cpu['train']['losses_crc']})")

    # ---- (b) reshard_soak: the race twice, a later NCCL world ------------
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = reshard_soak.main(["--repeat", "2", "--ledger-out",
                                str(tmp / "reshard_ledger.json")])
    out = json.loads(buf.getvalue())
    got = {"events_crc": out["events_crc"],
           "pause_win_s": out["pause_win_s"],
           "goodput_win": out["goodput_win"],
           **{arm: {k: out[arm][k] for k in ("pause_s", "goodput_fraction")}
              for arm in ("live", "restart")}}
    print(f"[tools] (b) reshard_soak --repeat 2: exit {rc}, {got}, "
          f"identical logs {out['identical_logs']}, ledger records "
          f"{out['ledger_records']}; {out['events'][0]}")
    if rc != 0 or got != RESHARD_FIGURES or dist.is_initialized():
        fail(f"phase 19 (b) reshard soak: rc {rc}, {got}, a world left "
             f"{dist.is_initialized()}")
    env = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    initialize(env, device=dev)
    mesh = create_mesh(MeshConfig(), device=dev)
    w = shard_pytree({"w": torch.ones(64, 64, device=dev)}, mesh,
                     [PartitionRule("w$", ("fsdp", None))])["w"]
    total = (w * 2).sum().full_tensor().item()
    backend = dist.get_backend()
    dist.destroy_process_group()
    try:
        reshard_soak.run_bench(RESHARD_SEED, dev)
        fail("phase 19 (b) --bench on one card did not raise")
    except RuntimeError as e:
        bench_error = str(e)
    print(f"[tools] (b) after the planner's fake world: an NCCL world of one "
          f"({backend}) lays out and reduces a DTensor: sum {total:g} (want "
          f"8192); --bench --device cuda on one card raises: {bench_error}; "
          f"{time.perf_counter() - t0:.1f} s")
    if backend != "nccl" or total != 8192 or "one card a rank" not in \
            bench_error:
        fail("phase 19 (b) the later NCCL world or the --bench refusal")

    # ---- (c) attn_micro at its default shape ----------------------------
    t0 = time.perf_counter()
    print("[tools] (c) attn_micro B {} L {} H {} D {} bf16 causal on "
          "{}:".format(*ATTN_MICRO_SHAPE, gpu))
    reset_counts(mods)
    attn_micro.main([str(x) for x in ATTN_MICRO_SHAPE])
    torch.cuda.synchronize()
    paths["attn_micro"] = read_counts(mods)
    q, k, v = (t.transpose(1, 2) for t in attn_micro.make_inputs(
        *ATTN_MICRO_SHAPE, dev))
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    po, plse = fa.flash_attention_plain(q, k, v, True)
    do = (2 * o.float()).to(torch.bfloat16)       # d sum(o.float() ** 2)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    grads = fa.flash_bwd(q, k, v, o, lse, do, True)
    plain = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
             *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True))
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    rels = [((g.float() - p.float()).abs().max()
             / p.float().abs().max()).item() for g, p in zip(grads, plain)]
    tol_o, tol_lse = TOL[torch.bfloat16]
    ok = (err_o <= tol_o and err_lse <= tol_lse
          and max(rels) <= BWD_REL_TOL[torch.bfloat16])
    print(f"[tools] (c) flash against the plain attention on attn_micro's "
          f"inputs: max|o-plain| {err_o:.3e} max|lse-plain| {err_lse:.3e} "
          f"rel dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tols "
          f"{tol_o:g}, {tol_lse:g}, {BWD_REL_TOL[torch.bfloat16]:g}); "
          f"launches {paths['attn_micro']}; {time.perf_counter() - t0:.1f} s")
    if not ok or not all(paths["attn_micro"][n] for n in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        fail("phase 19 (c) attn_micro's flash rows")
    del q, k, v, o, lse, po, plse, do, delta, grads, plain
    torch.cuda.empty_cache()

    # ---- (d) perf_sweep: the runbook's control, then on the int8 kernel --
    t0 = time.perf_counter()
    n_layers = perf_sweep.bench_config().n_layers
    sweep = {}
    for spec in SWEEP_VARIANTS:
        reset_counts(mods)
        row = perf_sweep.run_variant(spec, dev, steps=SWEEP_STEPS)
        torch.cuda.synchronize()
        sweep[spec] = (row, read_counts(mods))
        torch.cuda.empty_cache()
    paths["sweep"] = {name: sum(c[name] for _, c in sweep.values())
                      for name in COUNTERS}
    for spec, (row, got) in sweep.items():
        print(f"[tools] (d) {gpu}: {spec}: step {row['step_ms']:.1f} ms, "
              f"{row['tok_s']:.1f} tok/s, MFU {row['mfu']:.4f} of 989 "
              f"TFLOP/s bf16 dense (6 x {perf_sweep.n_params(perf_sweep.bench_config()):,} "
              f"params x tok/s), loss {row['loss']:.5f}; launches {got}")
    control, pallas = (sweep[s][1] for s in SWEEP_VARIANTS)
    # the fused gate+up and the down product a layer, and the gate+up again
    # in remat "mlp"'s recompute, over 3 warm-up and the timed steps
    want8 = 3 * n_layers * (3 + SWEEP_STEPS)
    if (control["int8_matmul"] or pallas["int8_matmul"] != want8
            or not all(math.isfinite(r["loss"]) and r["step_ms"] > 0
                       for r, _ in sweep.values())):
        fail(f"phase 19 (d) sweep rows or launches (int8_matmul {want8} "
             f"expected in the pallas variant only)")
    print(f"[tools] (d) int8_matmul launches: control 0, i8impl=pallas "
          f"{pallas['int8_matmul']} = 3 x {n_layers} layers x "
          f"{3 + SWEEP_STEPS} steps; {time.perf_counter() - t0:.1f} s")

    # ---- (e) step_breakdown int8=1 nu=bf16 ------------------------------
    t0 = time.perf_counter()
    print(f"[tools] (e) step_breakdown int8=1 nu=bf16 on {gpu}:")
    reset_counts(mods)
    parts = step_breakdown.breakdown({"int8": "1", "nu": "bf16"}, dev,
                                     steps=BREAKDOWN_STEPS)
    torch.cuda.synchronize()
    paths["breakdown"] = read_counts(mods)
    torch.cuda.empty_cache()
    print(f"[tools] (e) {gpu}: parts fwd {parts['fwd']:.1f} ms, fwd+bwd "
          f"{parts['fwd_bwd']:.1f} ms, optimizer {parts['opt']:.1f} ms; sum "
          f"of parts {parts['sum_parts']:.1f} ms beside the full step "
          f"{parts['step']:.1f} ms; launches {paths['breakdown']}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(x) and x > 0 for x in parts.values()):
        fail(f"phase 19 (e) breakdown {parts}")

    # ---- (f) longcontext_proof's card half, the kernels at its shapes ----
    t0 = time.perf_counter()
    reset_counts(mods)
    lc = longcontext_proof.card_part(tmp / "LONGCONTEXT_torch.json", dev)
    torch.cuda.synchronize()
    paths["longcontext"] = read_counts(mods)
    torch.cuda.empty_cache()
    for label in ("flash_4096", "flash_4000_padded"):
        r = lc[label]
        print(f"[tools] (f) {gpu}: {label}: loss {r['loss']:.5f}, step "
              f"{r['step_ms']} ms, {r['tokens_per_sec']} tokens/s, one "
              f"step's peak over the held bytes {r['temp_bytes']:,} B "
              f"beside the naive score matrix "
              f"{r['naive_score_matrix_bytes']:,} B; {r['attn_path']}")
        if not r["loss_finite"]:
            fail(f"phase 19 (f) {label} loss not finite")
    print(f"[tools] (f) ragged_cliff_check {lc['ragged_cliff_check']}; "
          f"launches {paths['longcontext']}")
    long = long_kernels(fa, gpu, dev)
    print(f"[tools] (f) {time.perf_counter() - t0:.1f} s")

    # ---- (g) driver_bench ------------------------------------------------
    t0 = time.perf_counter()
    reset_counts(mods)
    benches = {
        "resnet50": driver_bench.bench_resnet50(batch=256, steps=3,
                                                device=dev),
        "decode": driver_bench.bench_decode(batch=8, prompt_len=128,
                                            new_tokens=32, device=dev),
        "continuous": driver_bench.bench_continuous(
            n_requests=16, new_tokens=32, device=dev),
        "speculative": driver_bench.bench_speculative(new_tokens=27,
                                                      device=dev),
        "submit": driver_bench.bench_submit_to_first_step(n_jobs=5)}
    torch.cuda.synchronize()
    paths["driver_bench"] = read_counts(mods)
    torch.cuda.empty_cache()
    for name, rec in benches.items():
        print(f"[tools] (g) {gpu}: {json.dumps(rec)}")
    print(f"[tools] (g) launches {paths['driver_bench']}; "
          f"{time.perf_counter() - t0:.1f} s")
    if (benches["continuous"]["served"] != 16
            or benches["submit"]["samples"] != 5
            or not all(benches[n]["value"] > 0 for n in benches)):
        fail("phase 19 (g) driver_bench gates")
    print(f"[time] phase 19 {time.perf_counter() - t_phase:.1f} s")
    return {"paths": paths, "long": long}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    # checkpoints and record files of phases 3d and 4c, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(Path(tmp))


def run(tmp: Path) -> int:

    from tpu_on_k8s_torch import chaos as chaos_mod
    from tpu_on_k8s_torch import metrics as metrics_mod
    from tpu_on_k8s_torch.models import convert, decode, serving, transformer
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.ops import _build
    from tpu_on_k8s_torch.ops import flash_attention as fa
    from tpu_on_k8s_torch.ops import int8_matmul as i8
    from tpu_on_k8s_torch.ops import quantization as qz
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import trainer as trainer_mod

    mods = {"fa": fa, "i8": i8, "qz": qz}
    by_path = {}    # path -> every kernel's launches in that path's run
    t_start = time.perf_counter()
    # ---- 1. environment and build --------------------------------------
    gpu = gpu_line()
    print(f"[env] nvidia-smi: {gpu}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] torch.backends.cuda.matmul.allow_tf32 = False: fp32 "
          "matmuls run at full fp32 precision")
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] {', '.join(paths)} with nvcc {' '.join(_build.NVCC_FLAGS)}"
          f", in parallel, in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "wgmma" in line or "setmaxnreg" in line):
                print(f"[build] {name}: {line.strip()}")
    stats = {name: sass_stats(paths[name])
             for name in {lib for lib, _ in WGMMA_KERNELS}}
    for name, kernel in WGMMA_KERNELS:
        found = {fn: v for fn, v in stats[name].items() if kernel in fn}
        for fn, (n, top) in found.items():
            print(f"[build] {name}: {n} wgmma (HGMMA/IGMMA) instructions, "
                  f"highest register R{top}, in {fn}")
        if not found or not all(n for n, _ in found.values()):
            fail(f"{kernel} holds no wgmma (HGMMA/IGMMA) instructions: "
                 f"{found}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def qkv(b, h, hkv, l, d, dtype):
        return (randn(b, h, l, d, dtype=dtype), randn(b, hkv, l, d, dtype=dtype),
                randn(b, hkv, l, d, dtype=dtype))

    def segments_for(b, l):
        # three packed documents per row, boundaries drawn per row
        cuts = torch.sort(torch.randint(1, l, (b, 2), generator=gen,
                                        device=dev), dim=-1).values
        pos = torch.arange(l, device=dev)
        return ((pos[None] >= cuts[:, :1]).int()
                + (pos[None] >= cuts[:, 1:]).int()).to(torch.int32)

    def segments_across_tile(b, l):
        # three documents per row cut at rows 120 and 136 (across row 128)
        pos = torch.arange(l, device=dev)
        return ((pos >= 120).int() + (pos >= 136).int()).to(
            torch.int32)[None].repeat(b, 1)

    # ---- 2. kernels against their plain versions -----------------------
    cases = [  # (b, h, hkv, l, d, dtype, causal, valid_len, segmented)
        (2, 32, 8, 512, 128, torch.bfloat16, True, 0, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, False),
        (2, 32, 8, 512, 128, torch.bfloat16, False, 0, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, True),
        (2, 32, 8, 512, 128, torch.bfloat16, True, 400, False),
        (2, 16, 8, 333, 64, torch.bfloat16, True, 0, False),
        (2, 16, 16, 200, 64, torch.bfloat16, False, 0, True),
        (2, 32, 8, 333, 128, torch.float32, True, 0, False),
        (2, 32, 8, 333, 128, torch.float32, False, 0, True),
        (2, 16, 4, 200, 64, torch.float32, True, 150, False),
        # head dim 256 (google/gemma-7b's 16 heads x 256)
        (2, 16, 16, 512, 256, torch.bfloat16, True, 0, False),
        (2, 16, 8, 333, 256, torch.bfloat16, True, 0, True),
        (2, 16, 16, 333, 256, torch.bfloat16, False, 0, True),
        (2, 16, 4, 512, 256, torch.bfloat16, True, 400, False),
        (2, 16, 8, 333, 256, torch.float32, True, 0, False),
        (2, 16, 16, 333, 256, torch.float32, False, 0, True),
        (2, 16, 4, 200, 256, torch.float32, True, 150, False),
    ]
    misses = []
    bf16_err = 0.0
    for b, h, hkv, l, d, dtype, causal, valid, segmented in cases:
        q, k, v = qkv(b, h, hkv, l, d, dtype)
        seg = segments_for(b, l) if segmented else None
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        po, plse = fa.flash_attention_plain(q, k, v, causal, valid, seg)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        tol_o, tol_lse = TOL[dtype]
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and bool(torch.isfinite(o).all()))
        if dtype == torch.bfloat16:
            bf16_err = max(bf16_err, err_o)
        label = (f"B={b} H={h} Hkv={hkv} L={l} D={d} "
                 f"{dtype_name(dtype)} causal={causal} "
                 f"valid_len={valid} segments={segmented}")
        print(f"[kernel] flash_fwd {label}: max|o-plain| {err_o:.3e} "
              f"(tol {tol_o:g}) max|lse-plain| {err_lse:.3e} "
              f"(tol {tol_lse:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    # the serving path's own calls: contiguous [B, L, H, D] projections (as
    # ``Attention`` makes them) through ``flash_attention``, so the kernel
    # reads strided [B, H, L, D] views; at both requests' prefill shapes
    tol_o, tol_lse = TOL[torch.bfloat16]
    for b, l in ((4, 512), (1, 333)):
        h, hkv, d = 32, 8, 128
        q, k, v = (torch.randn(b, l, n, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, hkv, hkv))
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, causal=True)
        views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        _, lse = fa.flash_with_lse_fwd(*views, True)
        po, plse = fa.flash_attention_plain(*views, True)
        torch.cuda.synchronize()
        err_o = (got.float() - po.transpose(1, 2).float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and bool(torch.isfinite(got).all()))
        bf16_err = max(bf16_err, err_o)
        label = f"flash_attention [B,L,H,D] B={b} L={l} H={h} Hkv={hkv} D={d}"
        print(f"[kernel] {label} bf16 causal: max|o-plain| {err_o:.3e} "
              f"(tol {tol_o:g}) max|lse-plain| {err_lse:.3e} "
              f"(tol {tol_lse:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)

    # backward: dq, dk, dv from the kernels against the plain twins, from
    # the forward kernel's o and lse; the llama2_7b (32/8) and llama2_1b
    # (16/8, and 16/16 after the training path's repeat) head shapes
    bwd_cases = [  # (b, h, hkv, l, d, dtype, causal, valid, segmented, g_lse)
        (2, 32, 8, 512, 128, torch.bfloat16, True, 0, False, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, False, False),
        (2, 32, 8, 512, 128, torch.bfloat16, False, 0, False, False),
        (2, 32, 8, 512, 128, torch.bfloat16, True, 400, False, False),
        (2, 16, 8, 512, 128, torch.bfloat16, True, 0, False, False),
        (2, 16, 8, 333, 128, torch.bfloat16, False, 0, True, False),
        (2, 16, 16, 333, 128, torch.bfloat16, True, 0, True, False),
        (2, 16, 4, 333, 64, torch.bfloat16, True, 0, False, False),
        (2, 16, 8, 512, 128, torch.bfloat16, True, 0, False, True),
        (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128, torch.bfloat16, True, 0, False,
         False),
        (2, 32, 8, 333, 128, torch.float32, True, 0, False, False),
        (2, 16, 8, 333, 128, torch.float32, False, 0, True, False),
        (2, 16, 4, 200, 64, torch.float32, True, 150, False, True),
        # head dim 256
        (2, 16, 16, 512, 256, torch.bfloat16, True, 0, False, False),
        (2, 16, 8, 333, 256, torch.bfloat16, False, 0, True, False),
        (2, 16, 4, 333, 256, torch.bfloat16, True, 200, False, True),
        (2, 16, 8, 333, 256, torch.float32, True, 0, False, False),
        (2, 16, 16, 333, 256, torch.float32, False, 0, True, False),
        (2, 16, 4, 200, 256, torch.float32, True, 150, False, True),
    ]
    bwd_err = {"dq": 0.0, "dkv": 0.0}
    for b, h, hkv, l, d, dtype, causal, valid, segmented, cot in bwd_cases:
        q, k, v = qkv(b, h, hkv, l, d, dtype)
        do = randn(b, h, l, d, dtype=dtype)
        g_lse = randn(b, h, 1, l, dtype=torch.float32) if cot else None
        seg = segments_for(b, l) if segmented else None
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        got = fa.flash_bwd(q, k, v, o, lse, do, causal, valid, seg, g_lse)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        if cot:
            delta = delta - g_lse
        want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid,
                                      seg),
                *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                        valid, seg))
        torch.cuda.synchronize()
        label = (f"B={b} H={h} Hkv={hkv} L={l} D={d} "
                 f"{dtype_name(dtype)} causal={causal} "
                 f"valid_len={valid} segments={segmented} lse_cotangent={cot}")
        parts, ok = [], True
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - w.float()).abs().max().item()
            rel = err / w.float().abs().max().item()
            ok = ok and rel <= BWD_REL_TOL[dtype] and bool(
                torch.isfinite(a).all())
            if dtype == torch.bfloat16:
                key = "dq" if name == "dq" else "dkv"
                bwd_err[key] = max(bwd_err[key], err)
            parts.append(f"{name} max|err| {err:.3e} rel {rel:.2e}")
        print(f"[kernel] flash_bwd {label}: {', '.join(parts)} (tol rel "
              f"{BWD_REL_TOL[dtype]:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(f"flash_bwd {label}")
        del q, k, v, do, o, lse, got, want, delta
    # the bf16 forward, dq and dk/dv kernels at their tile edges, each
    # launched twice on the same inputs: the two results must be
    # bit-identical
    tol_o, tol_lse = TOL[torch.bfloat16]
    tol_bwd = BWD_REL_TOL[torch.bfloat16]
    for h, hkv, l, d, causal, valid, seg_kind in EDGE_CASES:
        q, k, v = qkv(1, h, hkv, l, d, torch.bfloat16)
        do = randn(1, h, l, d)
        seg = segments_across_tile(1, l) if seg_kind else None
        args = (causal, valid, seg)
        o, lse = fa.flash_with_lse_fwd(q, k, v, *args)
        o2, lse2 = fa.flash_with_lse_fwd(q, k, v, *args)
        po, plse = fa.flash_attention_plain(q, k, v, *args)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        grads = (fa.flash_bwd_dq(q, k, v, do, lse, delta, *args),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args))
        again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, *args),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, delta, *args))
        plain = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, *args),
                 *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, *args))
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        errs = [(a.float() - w.float()).abs().max().item()
                for a, w in zip(grads, plain)]
        rels = [e / w.float().abs().max().item()
                for e, w in zip(errs, plain)]
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(map(torch.equal, grads, again)))
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and max(rels) <= tol_bwd and same
              and bool(torch.isfinite(o).all())
              and all(bool(torch.isfinite(g).all()) for g in grads))
        bf16_err = max(bf16_err, err_o)
        bwd_err["dq"] = max(bwd_err["dq"], errs[0])
        bwd_err["dkv"] = max(bwd_err["dkv"], *errs[1:])
        label = (f"edge B=1 H={h} Hkv={hkv} L={l} D={d} bf16 causal={causal} "
                 f"valid_len={valid} segments={seg_kind}")
        print(f"[kernel] flash_fwd + flash_bwd_dq + flash_bwd_dkv {label}: "
              f"max|o-plain| {err_o:.3e} max|lse-plain| {err_lse:.3e} rel "
              f"dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tols "
              f"{tol_o:g}, {tol_lse:g}, {tol_bwd:g}); two launches "
              f"bit-identical {same} {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    # head dims the kernels are not built for: q, k, v (and dO) zero-padded
    # to 64, 128 or 256 in the wrappers, the outputs sliced back
    for d, l in HEAD_DIM_CASES:
        q, k, v = qkv(1, 4, 2, l, d, torch.bfloat16)
        do = randn(1, 4, l, d)
        o, lse = fa.flash_with_lse_fwd(q, k, v, True)
        po, plse = fa.flash_attention_plain(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        grads = (fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                 *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True))
        plain = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
                 *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        errs = [(a.float() - w.float()).abs().max().item()
                for a, w in zip(grads, plain)]
        rels = [e / w.float().abs().max().item()
                for e, w in zip(errs, plain)]
        ok = (err_o <= tol_o and err_lse <= tol_lse and max(rels) <= tol_bwd
              and o.shape == q.shape
              and all(g.shape == w.shape for g, w in zip(grads, plain))
              and bool(torch.isfinite(o).all()))
        bf16_err = max(bf16_err, err_o)
        bwd_err["dq"] = max(bwd_err["dq"], errs[0])
        bwd_err["dkv"] = max(bwd_err["dkv"], *errs[1:])
        label = f"head dim D={d} (padded to {fa.kernel_head_dim(d)}) B=1 H=4 " \
                f"Hkv=2 L={l} bf16 causal"
        print(f"[kernel] flash_fwd + flash_bwd_dq + flash_bwd_dkv {label}: "
              f"max|o-plain| {err_o:.3e} max|lse-plain| {err_lse:.3e} rel "
              f"dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tols "
              f"{tol_o:g}, {tol_lse:g}, {tol_bwd:g}) "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    # determinism at the training shape, where every block runs many tiles
    q, k, v = qkv(TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128, torch.bfloat16)
    do = randn(TRAIN_BATCH, 16, TRAIN_SEQ, 128)
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    o2, lse2 = fa.flash_with_lse_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    same = (torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True)) and all(map(
            torch.equal, fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            fa.flash_bwd_dkv(q, k, v, do, lse, delta, True))))
    print(f"[kernel] flash_fwd + flash_bwd_dq + flash_bwd_dkv B={TRAIN_BATCH} "
          f"H=16 L={TRAIN_SEQ} D=128 bf16 causal: two launches bit-identical "
          f"{same} {'ok' if same else 'MISS'}")
    if not same:
        misses.append("determinism at the training shape")
    del q, k, v, do, o, o2, lse, lse2, delta
    int8_errs = check_int8_kernels(i8, qz, randn, misses)
    check_division(i8, decode, misses)
    if misses:
        fail(f"kernels disagree with their plain versions: {misses}")

    # ---- 3. serving: generate at llama2_7b width -----------------------
    cfg = transformer.TransformerConfig.llama2_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[serve] llama2_7b: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params in "
          f"{dtype_name(cfg.dtype)} "
          f"({sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s")
    pgen = torch.Generator(device=dev).manual_seed(1)
    prompt4 = torch.randint(0, cfg.vocab_size, (4, 512), generator=pgen,
                            device=dev, dtype=torch.int32)
    prompt1 = torch.randint(0, cfg.vocab_size, (1, 333), generator=pgen,
                            device=dev, dtype=torch.int32)

    reset_counts(mods)
    greedy = decode.generate(cfg, params, prompt4, 64)
    torch.cuda.synchronize()
    after_greedy = fa.launches
    sampled = decode.generate(cfg, params, prompt1, 32, temperature=0.8,
                              top_p=0.9,
                              generator=torch.Generator(device=dev)
                              .manual_seed(2))
    torch.cuda.synchronize()
    serve_counts = counts(fa)
    by_path["serve"] = read_counts(mods)
    print(f"[serve] request 1: batch 4 x prompt 512 -> 64 tokens, greedy; "
          f"flash_fwd launches {after_greedy}")
    print(f"[serve] request 2: batch 1 x prompt 333 -> 32 tokens, "
          f"temperature 0.8 top_p 0.9; flash_fwd launches "
          f"{serve_counts[0] - after_greedy}")
    print(f"[serve] greedy row 0: {greedy[0, :16].tolist()} ...")
    print(f"[serve] sampled row 0: {sampled[0, :16].tolist()} ...")
    if (after_greedy != cfg.n_layers
            or serve_counts != (2 * cfg.n_layers, 0, 0)):
        fail(f"serving launches (flash_fwd, dq, dkv) {serve_counts}, first "
             f"prefill {after_greedy}; expected {cfg.n_layers} flash_fwd per "
             f"prefill and no backward")
    for name, toks, shape in (("greedy", greedy, (4, 64)),
                              ("sampled", sampled, (1, 32))):
        if tuple(toks.shape) != shape or toks.dtype != torch.int32:
            fail(f"{name} tokens {tuple(toks.shape)} {toks.dtype}")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{name} tokens outside [0, {cfg.vocab_size})")
    again = decode.generate(cfg, params, prompt4, 64)
    if not torch.equal(again, greedy):
        fail("a repeated greedy run gave other tokens")
    print("[serve] tokens in [0, vocab); repeated greedy run identical")

    def plain_flash(q, k, v, causal=True, segments=None):
        o, _ = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal, 0, segments)
        return o.transpose(1, 2)

    def prefill_logits(model_cfg, model_params):
        bcfg = dataclasses.replace(model_cfg, max_seq_len=decode._bucket_len(
            512 + 64, model_cfg.max_seq_len))
        model = decode.decode_model(bcfg, model_params, dev)
        with torch.inference_mode():
            return model(prompt4, None, decode.init_cache(model, 4))

    before = fa.launches
    logits_kernel = prefill_logits(cfg, params)
    if fa.launches - before != cfg.n_layers:
        fail("the kernel prefill did not launch flash_fwd once per layer")
    with mock.patch.object(transformer, "flash_attention", plain_flash):
        logits_plain = prefill_logits(cfg, params)
        # the same weights in fp32, activations in fp32: the reference
        # that shows how far bf16 rounding alone moves the logits
        logits_f32 = prefill_logits(
            dataclasses.replace(cfg, dtype=torch.float32),
            {name: p.float() for name, p in params.items()})
    torch.cuda.synchronize()
    diff = (logits_kernel - logits_plain).abs().max().item()
    noise = (logits_plain - logits_f32).abs().max().item()
    kernel_noise = (logits_kernel - logits_f32).abs().max().item()
    agree = (logits_kernel.argmax(-1) == logits_plain.argmax(-1)).float()
    print(f"[serve] prefill logits [4, 512, {cfg.vocab_size}] fp32: "
          f"max|kernel bf16 - fp32 model| {kernel_noise:.3e} (tol "
          f"{LOGITS_NOISE_MULT:g} x bf16 noise {noise:.3e} = max|plain bf16 "
          f"- fp32 model|); max|kernel - plain| {diff:.3e}; max |logit| "
          f"{logits_plain.abs().max().item():.3e}; argmax agreement "
          f"kernel/plain {agree.mean().item():.4f}")
    if not bool(torch.isfinite(logits_kernel).all()):
        fail("prefill logits not finite")
    if kernel_noise > LOGITS_NOISE_MULT * noise:
        fail("prefill logits with the kernel stray further from the fp32 "
             "model than bf16 rounding explains")
    del logits_kernel, logits_plain, logits_f32
    prefill_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 1))
    gen64_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 64),
                       GEN64_REPS)
    decode_ms = (gen64_ms - prefill_ms) / 63

    # ---- 3b. W8A16 serving from the same weights -----------------------
    w8 = serve_w8(cfg, params, prompt4, prefill_logits, mods, convert, decode)
    by_path["serve_w8"] = w8["counts"]

    # ---- 3c. int8 serving on both int8 routes; 3d. the CLIs' defaults ---
    by_path["serve_int8"] = serve_int8_routes(cfg, params, prompt4, mods,
                                              decode)

    # ---- 3e. continuous batching at llama2_7b width --------------------
    by_path["engine"], plain_a = serve_engine(
        cfg, params, mods, plain_flash, diff, gpu, serving, transformer,
        decode)

    # ---- 3f. disaggregated prefill at llama2_7b width -------------------
    by_path["disagg"] = serve_disagg(cfg, params, mods, plain_flash, gpu,
                                     serving, transformer, decode,
                                     metrics_mod)

    # ---- 3g. speculative decoding at llama2_7b width -------------------
    t0 = time.perf_counter()
    by_path["spec"] = serve_spec(cfg, params, w8.pop("tree"), mods,
                                 plain_flash, diff, gpu, plain_a, serving,
                                 transformer, decode, chaos_mod)
    print(f"[time] phase 3g {time.perf_counter() - t0:.1f} s")

    # ---- 3h. the int8 KV cache at llama2_7b width ----------------------
    by_path["kv_int8"] = serve_kv_int8(
        cfg, params, prompt4, greedy, (prefill_ms, gen64_ms, decode_ms),
        mods, plain_flash, diff, gpu, plain_a, serving, transformer, decode)

    # ---- 7. the serving plane at llama2_7b width ------------------------
    by_path.update(serve_plane(cfg, params, mods, plain_flash, diff, plain_a,
                               serving, transformer, decode, chaos_mod,
                               metrics_mod, dev))
    del params
    torch.cuda.empty_cache()
    by_path["cli"] = run_clis(mods, dev, tmp)

    # ---- 4. training: llama2_1b, full width and depth ------------------
    tcfg = dataclasses.replace(transformer.TransformerConfig.llama2_1b(),
                               remat=True, remat_policy="mlp",
                               attn_impl="flash")
    tgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    tparams = init_params(tcfg, tgen, dev, dtype=tcfg.param_dtype)
    tokens = torch.randint(0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=tgen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tparams.values())
    print(f"[train] llama2_1b: {tcfg.n_layers} layers d_model {tcfg.d_model} "
          f"heads {tcfg.n_heads}/{tcfg.n_kv_heads} d_ff {tcfg.d_ff} vocab "
          f"{tcfg.vocab_size}, {n_train:,} params, fp32 masters, bf16 "
          f"compute, attn flash (kv repeated to {tcfg.n_heads} heads), "
          f"remat mlp; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; init "
          f"{time.perf_counter() - t0:.1f} s")
    by_path["pytree"] = pytree_roundtrip(tparams, mods)["counts"]
    torch.cuda.empty_cache()

    # the gradient gate: the first step's gradients on these weights, with
    # remat "full" to bound memory, from the kernel model and from
    # plain-attention models in bf16 and in fp32
    def plain_bhld(q, k, v, causal=True, valid_len=0, segments=None):
        return fa.flash_attention_plain(q, k, v, causal, valid_len,
                                        segments)[0]

    def first_grads(model_cfg, plain):
        model = load_model(model_cfg, tparams, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = (mock.patch.object(transformer, "flash_attention_bhld",
                                   plain_bhld) if plain else nullcontext())
        with patch:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), dict(zip(names, grads))

    gcfg = dataclasses.replace(tcfg, remat_policy="full")
    reset_counts(mods)
    loss_k, grads_k = first_grads(gcfg, plain=False)
    torch.cuda.synchronize()
    full_counts = counts(fa)
    loss_p, grads_p = first_grads(gcfg, plain=True)
    loss_32, grads_32 = first_grads(
        dataclasses.replace(gcfg, dtype=torch.float32), plain=True)
    torch.cuda.synchronize()
    print(f"[train] remat full, one forward+backward: launches flash_fwd "
          f"{full_counts[0]}, dq {full_counts[1]}, dkv {full_counts[2]} "
          f"(the forward runs again in each block's recompute)")
    if full_counts != (2 * tcfg.n_layers, tcfg.n_layers, tcfg.n_layers):
        fail(f"remat full launches {full_counts}; expected "
             f"({2 * tcfg.n_layers}, {tcfg.n_layers}, {tcfg.n_layers})")

    def rel_dist(g, ref):
        return {n: ((g[n].float() - ref[n]).norm() / ref[n].norm()).item()
                for n in ref}

    dist_k, dist_p = rel_dist(grads_k, grads_32), rel_dist(grads_p, grads_32)
    worst_k, worst_p = max(dist_k.values()), max(dist_p.values())
    ratios = sorted(dist_k[n] / dist_p[n] for n in dist_k)
    worst_name = max(dist_k, key=dist_k.get)
    print(f"[train] gradient gate, step 1, {len(dist_k)} tensors, "
          f"||g - g_fp32|| / ||g_fp32||: kernel bf16 max {worst_k:.4e} "
          f"(at {worst_name}), median {statistics.median(dist_k.values()):.4e}"
          f"; plain bf16 max {worst_p:.4e}, median "
          f"{statistics.median(dist_p.values()):.4e}; per-tensor ratio "
          f"kernel/plain median {statistics.median(ratios):.3f}, max "
          f"{ratios[-1]:.3f} (limit {GRAD_NOISE_MULT:g})")
    print(f"[train] gradient gate, step-1 loss: kernel bf16 {loss_k:.6f}, "
          f"plain bf16 {loss_p:.6f}, fp32 {loss_32:.6f}")
    for name in ("embed", "blocks.0.attn.wq.weight", "blocks.0.attn.wk.weight",
                 "blocks.15.attn.wv.weight", "blocks.15.mlp.w_down.weight",
                 "lm_head"):
        print(f"[train]   {name}: kernel {dist_k[name]:.4e} plain "
              f"{dist_p[name]:.4e}")
    if not all(torch.isfinite(g).all() for g in grads_k.values()):
        fail("kernel-model gradients not finite")
    if ratios[-1] > GRAD_NOISE_MULT:
        fail("the kernel model's gradients stray further from the fp32 "
             "model's than bf16 rounding explains")
    del grads_k, grads_p, grads_32
    torch.cuda.empty_cache()

    # the MLP's selective checkpoint: the dense products its backward runs
    # again, as the backward's aten.mm calls with remat "mlp" less those
    # without remat (one sequence of the batch; the count is per layer)
    products = {}
    for label, mcfg in (("remat mlp", tcfg),
                        ("no remat", dataclasses.replace(tcfg, remat=False))):
        model = load_model(mcfg, tparams, dev)
        products[label] = backward_products(
            model, trainer_mod._make_loss_fn(model, 0, None), tokens[:1])
        del model
    rerun = products["remat mlp"] - products["no remat"]
    print(f"[train] backward aten.mm calls, llama2_1b: remat mlp "
          f"{products['remat mlp']}, no remat {products['no remat']}: the "
          f"MLP's backward re-runs {rerun} dense products (0 expected: the "
          f"gate and up outputs are kept)")
    if rerun:
        fail("the MLP's backward re-runs dense products")
    torch.cuda.empty_cache()

    model = load_model(tcfg, tparams, dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10,
        decay_steps=max(TRAIN_STEPS, 11)))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    reset_counts(mods)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(tokens)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_counts = counts(fa)
    by_path["train"] = read_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {TRAIN_STEPS} steps on one fixed batch: loss "
          f"{[round(x, 5) for x in losses]}")
    print(f"[train] grad_norm {[round(x, 4) for x in norms]}")
    print(f"[train] launches over {TRAIN_STEPS} steps: flash_fwd "
          f"{train_counts[0]}, dq {train_counts[1]}, dkv {train_counts[2]} "
          f"({tcfg.n_layers} layers, remat mlp)")
    want = tuple(TRAIN_STEPS * tcfg.n_layers for _ in range(3))
    if train_counts != want:
        fail(f"training launches {train_counts}; expected {want}: one "
             f"flash_fwd, dq and dkv per layer per step")
    if not all(map(math.isfinite, losses)):
        fail(f"training loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    train_ms = statistics.median(step_ms[1:])
    print(f"[train] step wall ms {[round(x, 1) for x in step_ms]}; median "
          f"of steps 2-{TRAIN_STEPS} {train_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train_ms * 1e3:,.0f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB")
    p4 = dict(losses=losses, norms=norms, ms=train_ms, peak_gb=peak_gb)
    del trainer, model, tparams
    torch.cuda.empty_cache()

    # ---- 4b. int8 training: the same model with every int8 flag --------
    i8cfg = dataclasses.replace(tcfg, mlp_int8=True, mlp_fused_gateup=True,
                                head_int8=True, attn_int8=True,
                                int8_impl="pallas")
    # the same initial weights as phase 4 (same seed), gate+up fused
    p8 = fuse_gateup(init_params(tcfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev,
                                 dtype=tcfg.param_dtype), tcfg.n_layers)
    # per step: q, k, v, o and the MLP's gate+up and down in every layer,
    # the gate+up again in its backward recompute (remat "mlp": the
    # kernel's output is no dot; the recompute stops before w_down's
    # product, whose output the backward never reads), and the head: 113,
    # as the reference's XLA runs them
    int8_per_step = (4 + 2 + 1) * tcfg.n_layers + 1

    def int8_grads(model_cfg, plain):
        model = load_model(model_cfg, p8, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = (mock.patch.object(i8, "int8_matmul_kernel",
                                   i8.int8_matmul_plain)
                 if plain else nullcontext())
        with patch:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), dict(zip(names, grads))

    reset_counts(mods)
    loss_k8, grads_k8 = int8_grads(i8cfg, plain=False)
    torch.cuda.synchronize()
    gate8_counts = read_counts(mods)
    loss_p8, grads_p8 = int8_grads(i8cfg, plain=True)
    torch.cuda.synchronize()
    print(f"[train-int8] llama2_1b with mlp_int8, mlp_fused_gateup, "
          f"head_int8, attn_int8, int8_impl pallas, remat mlp, flash; one "
          f"forward+backward: launches {gate8_counts} (int8_matmul expected "
          f"{int8_per_step})")
    if (gate8_counts["int8_matmul"] != int8_per_step
            or gate8_counts["flash_fwd"] != tcfg.n_layers):
        fail(f"int8 step launches {gate8_counts}; expected {int8_per_step} "
             f"int8_matmul")
    same = [n for n in grads_k8 if torch.equal(grads_k8[n], grads_p8[n])]
    rel8 = max(((grads_k8[n].float() - grads_p8[n].float()).norm()
                / grads_p8[n].float().norm()).item() for n in grads_k8)
    print(f"[train-int8] gate, step 1: loss kernel {loss_k8:.6f}, plain "
          f"int8 GEMM {loss_p8:.6f} (equal {loss_k8 == loss_p8}); gradients "
          f"bit-identical in {len(same)} of {len(grads_k8)} tensors, max "
          f"||g - g_plain|| / ||g_plain|| {rel8:.3e}")
    if loss_k8 != loss_p8 or len(same) != len(grads_k8):
        fail("the int8 kernel model's first step differs from the same model "
             "with the int8 GEMM's plain version")
    del grads_p8
    loss_b8, grads_b8 = int8_grads(dataclasses.replace(
        i8cfg, mlp_int8=False, head_int8=False, attn_int8=False), plain=False)
    dist8 = {n: ((grads_k8[n].float() - grads_b8[n].float()).norm()
                 / grads_b8[n].float().norm()).item() for n in grads_k8}
    print(f"[train-int8] for information, step 1 against the bf16 model of "
          f"the same weights: loss int8 {loss_k8:.6f}, bf16 {loss_b8:.6f}; "
          f"||g_int8 - g_bf16|| / ||g_bf16|| median "
          f"{statistics.median(dist8.values()):.4e}, max "
          f"{max(dist8.values()):.4e} (at {max(dist8, key=dist8.get)})")
    for name in ("embed", "blocks.0.attn.wq.weight",
                 "blocks.0.mlp.w_gateup.weight",
                 "blocks.15.mlp.w_down.weight", "lm_head"):
        print(f"[train-int8]   {name}: {dist8[name]:.4e}")
    del grads_k8, grads_b8
    torch.cuda.empty_cache()

    model = load_model(i8cfg, p8, dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10,
        decay_steps=max(TRAIN_STEPS, 11)))
    torch.cuda.reset_peak_memory_stats()
    losses8, step8_ms = [], []
    reset_counts(mods)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses8.append(float(trainer.train_step(tokens)["loss"]))
        torch.cuda.synchronize()
        step8_ms.append((time.perf_counter() - t0) * 1e3)
    by_path["train_int8"] = read_counts(mods)
    peak8_gb = torch.cuda.max_memory_allocated() / 1e9
    train8_ms = statistics.median(step8_ms[1:])
    print(f"[train-int8] {TRAIN_STEPS} steps on the same batch: loss "
          f"{[round(x, 5) for x in losses8]}; launches "
          f"{by_path['train_int8']}")
    want8 = {"int8_matmul": TRAIN_STEPS * int8_per_step,
             "flash_fwd": TRAIN_STEPS * tcfg.n_layers,
             "flash_bwd_dq": TRAIN_STEPS * tcfg.n_layers,
             "flash_bwd_dkv": TRAIN_STEPS * tcfg.n_layers}
    if any(by_path["train_int8"][k] != v for k, v in want8.items()):
        fail(f"int8 training launches {by_path['train_int8']}; expected "
             f"{want8}")
    if not all(map(math.isfinite, losses8)) or not losses8[-1] < losses8[0]:
        fail(f"int8 training loss not finite or not falling: {losses8}")
    print(f"[train-int8] step wall ms {[round(x, 1) for x in step8_ms]}; "
          f"median of steps 2-{TRAIN_STEPS} {train8_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train8_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak8_gb:.2f} GB (bf16 step {train_ms:.1f} ms, peak "
          f"{peak_gb:.2f} GB)")
    p4.update(losses8=losses8, ms8=train8_ms, peak8_gb=peak8_gb)
    del trainer, model, p8
    torch.cuda.empty_cache()

    # ---- 4c. the training loop and checkpoints at llama2_1b -------------
    t0 = time.perf_counter()
    by_path["train_loop"] = train_loop_phase(tcfg, mods, gpu, dev, train_ms,
                                             tmp, p4)
    print(f"[time] phase 4c {time.perf_counter() - t0:.1f} s")

    # ---- 4d. the remat policies at llama2_1b ---------------------------
    t0 = time.perf_counter()
    by_path["remat"] = remat_phase(tcfg, mods, gpu, dev, tokens, trainer_mod)
    print(f"[time] phase 4d {time.perf_counter() - t0:.1f} s")

    # ---- 5. times -----------------------------------------------------
    scfg = transformer.TransformerConfig.llama2_7b()
    b, h, hkv, l, d = 4, scfg.n_heads, scfg.n_kv_heads, 512, scfg.head_dim
    q, k, v = qkv(b, h, hkv, l, d, torch.bfloat16)
    serve_fwd_ms = time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True))
    serve_plain_ms = plain_time_ms(
        lambda: fa.flash_attention_plain(q, k, v, True))
    serve_sdpa_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    serve_bound, serve_by = flash_bound_ms(b, h, hkv, l, d, True)
    print(f"[time] {gpu}: flash_fwd B={b} H={h} Hkv={hkv} L={l} D={d} bf16 "
          f"causal (serving prefill): kernel {serve_fwd_ms:.4f} ms, plain "
          f"{serve_plain_ms:.4f} ms, sdpa {serve_sdpa_ms:.4f} ms, bound "
          f"{serve_bound:.4f} ms ({serve_by}); "
          f"{serve_bound / serve_fwd_ms:.1%} of bound")
    print(f"[time] {gpu}: generate llama2_7b bf16 batch 4 x prompt 512: "
          f"prefill (+1 token) {prefill_ms:.2f} ms, 64 tokens "
          f"{gen64_ms:.2f} ms, per-token decode {decode_ms:.3f} ms")

    # the training path's attention: kv repeated to 16 heads, L 2048
    b, h, hkv, l, d = TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128
    q, k, v = qkv(b, h, hkv, l, d, torch.bfloat16)
    do = randn(b, h, l, d)
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    shape = f"B={b} H={h} Hkv={hkv} L={l} D={d} bf16 causal"
    timed = {
        "flash_fwd": (
            time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True)),
            plain_time_ms(lambda: fa.flash_attention_plain(q, k, v, True)),
            flash_bound_ms(b, h, hkv, l, d, True)),
        "flash_bwd_dq": (
            time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
            plain_time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse,
                                                        delta, True)),
            dq_bound_ms(b, h, hkv, l, d, True)),
        "flash_bwd_dkv": (
            time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
            plain_time_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                         delta, True)),
            dkv_bound_ms(b, h, hkv, l, d, True)),
    }
    sdpa_fwd_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    fn, stream = sdpa_backward(q, k, v, do, is_causal=True)
    sdpa_bwd_ms = time_ms(fn, stream=stream)
    library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": sdpa_bwd_ms,
               "flash_bwd_dkv": sdpa_bwd_ms}
    for name, (ms, plain, (bound, by)) in timed.items():
        print(f"[time] {gpu}: {name} {shape} (training): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of bound; sdpa "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
              f" {library[name]:.4f} ms")
    print(f"[time] {gpu}: train step llama2_1b batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (remat mlp, flash): bf16 {train_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; int8 (every flag, pallas) "
          f"{train8_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train8_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak8_gb:.2f} GB")
    print(f"[time] {gpu}: generate llama2_7b W8A16 batch 4 x prompt 512: "
          f"prefill (+1 token) {w8['prefill_ms']:.2f} ms, 64 tokens "
          f"{w8['gen64_ms']:.2f} ms, per-token decode {w8['decode_ms']:.3f} "
          f"ms (bf16: {prefill_ms:.2f}, {gen64_ms:.2f}, {decode_ms:.3f})")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    # the int8 GEMM at the training shapes: kernel, plain, and
    # torch._int_mm with the epilogue in PyTorch (the library yardstick:
    # two calls, the int32 product and then the fp32 rescale and cast)
    int8_times = {}
    for m, n, kk, out_dtype in INT8_CASES[:5]:
        xq, sx = i8._quant_rows(randn(m, kk))
        wq, sw = i8._quant_rows(randn(n, kk) * 0.02)
        ms = time_ms(lambda: i8.int8_matmul_kernel(xq, sx, wq, sw, out_dtype))
        plain = event_ms(lambda: i8.int8_matmul_plain(xq, sx, wq, sw,
                                                       out_dtype))
        lib = time_ms(lambda: i8._int_mm(xq, sx, wq, sw, out_dtype))
        bound, by = int8_bound_ms(m, n, kk, out_dtype)
        int8_times[(m, n, kk)] = (ms, plain, bound, by, lib)
        print(f"[time] {gpu}: int8_matmul M={m} N={n} K={kk} out "
              f"{dtype_name(out_dtype)}: kernel {ms:.4f} ms "
              f"({2 * m * n * kk / ms / 1e9:,.0f} TOP/s), plain {plain:.4f} "
              f"ms, torch._int_mm + epilogue {lib:.4f} ms, bound {bound:.4f} "
              f"ms ({by}), {bound / ms:.1%} of bound")
        del xq, wq
    # quantize at a llama2_7b MLP matrix (the W8 tree's largest group);
    # no single PyTorch call rounds stochastically, so no library time
    qr, qc, qdt = 11008, 4096, torch.bfloat16
    x = randn(qr, qc, dtype=qdt) * 0.02
    quant_t = (time_ms(lambda: qz.quantize_int8(x, seed=W8_SEED)),
               event_ms(lambda: qz.quantize_int8_plain(x, seed=W8_SEED)),
               *quant_bound_ms(qr, qc, qdt), None)
    # dequantize at a llama2_1b MLP master (fp32 out); the library
    # yardstick is one torch.mul(values, scales) with type promotion
    dr, dc, ddt = 5632, 2048, torch.float32
    values, scales = qz.quantize_int8(randn(dr, dc, dtype=ddt), seed=1)
    dequant_t = (time_ms(lambda: qz.dequantize_int8(values, scales, ddt)),
                 event_ms(lambda: qz.dequantize_int8_plain(values, scales,
                                                           ddt)),
                 *dequant_bound_ms(dr, dc, ddt),
                 time_ms(lambda: torch.mul(values, scales)))
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    issue = quant_issue_figure(paths["quantization"], qr, qc, clock)
    print(f"[time] {gpu}: quantize_int8 issue figure R={qr} C={qc} bf16: "
          f"quant_kernel<bf16, {issue['steps']}> has {issue['hot']} SASS "
          f"instructions on its common path (of {issue['all']}) for the "
          f"{issue['steps'] * 8} elements a thread rounds: "
          f"{issue['per_elem']:.1f} an element x {qr * qc} elements / (132 "
          f"SMs x 4 x 32 lanes x {clock:.0f} MHz) = {issue['ms']:.4f} ms, "
          f"beside the byte bound {quant_t[2]:.4f} ms")
    for name, (ms, plain, bound, by, lib), label in (
            ("quantize_int8", quant_t, f"R={qr} C={qc} {dtype_name(qdt)}"),
            ("dequantize_int8", dequant_t,
             f"R={dr} C={dc} -> {dtype_name(ddt)}")):
        print(f"[time] {gpu}: {name} {label}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound")

    # ---- 5b. head dim 256 ------------------------------------------------
    d256 = head_dim_256_phase(mods, gpu, dev, fa, transformer, decode,
                              trainer_mod, init_params, load_model)
    by_path.update(d256["paths"])

    # ---- 6. the GPT-2 family at gpt2_small width -----------------------
    gpt2 = gpt2_phase(mods, gpu, dev, tmp, plain_flash, fa, transformer,
                      decode, serving, convert, trainer_mod)
    by_path.update(gpt2["paths"])

    # ---- 8. mesh-sharded training at llama2_1b --------------------------
    by_path.update(mesh_phase(tcfg, i8cfg, mods, gpu, dev, tokens, p4, tmp))

    # ---- 9. mesh-sharded serving at llama2_7b width -----------------------
    by_path.update(mesh_serve_phase(cfg, mods, gpu, dev, plain_a, serving,
                                    convert, metrics_mod))

    # ---- 10. the vision models and BERT ----------------------------------
    phase10 = vision_bert_phase(mods, gpu, dev, tmp, fa)
    by_path.update(phase10["paths"])

    # ---- 11. sequence and pipeline parallelism ---------------------------
    phase11 = seq_phase(tcfg, mods, gpu, dev, tokens, fa)
    by_path.update(phase11["paths"])

    # ---- 12. MoE -----------------------------------------------------------
    phase12 = moe_phase(tokens, mods, gpu, dev, fa)
    by_path.update(phase12["paths"])

    # ---- 13. a TorchJob runs the trainer on the card ---------------------
    torchjob_phase(gpu, tmp)

    # ---- 14. an elastic TorchJob driven by the card ----------------------
    by_path.update(elastic_phase(mods, gpu, dev, tmp, transformer)["paths"])

    # ---- 15. the serving control plane over gpt2_small replicas ----------
    by_path.update(fleet_autoscale_phase(
        mods, gpu, dev, plain_flash, transformer, decode, convert,
        gpt2["diff"])["paths"])

    # ---- 16. the capacity market over gpt2_small -----------------------
    by_path.update(broker_phase(
        mods, gpu, dev, plain_flash, transformer, decode, convert,
        gpt2["diff"], tmp)["paths"])

    # ---- 17. the load driver on the card ---------------------------------
    by_path.update(load_phase(mods, gpu, tmp)["paths"])

    # ---- 18. the digital twin priced by the card -------------------------
    by_path.update(twin_phase(mods, gpu, dev, convert, tmp)["paths"])

    # ---- 19. the drivers of tools/ on the card ----------------------------
    phase19 = tools_phase(mods, gpu, dev, fa, tmp)
    by_path.update(phase19["paths"])
    print(f"[time] script {time.perf_counter() - t_start:.0f} s")

    gemm = (TRAIN_BATCH * TRAIN_SEQ, 11264, 2048)
    ms8, plain8, bound8, by8, lib8 = int8_times[gemm]
    timed.update({
        "int8_matmul": (ms8, plain8, (bound8, by8)),
        "quantize_int8": (quant_t[0], quant_t[1], quant_t[2:4]),
        "dequantize_int8": (dequant_t[0], dequant_t[1], dequant_t[2:4])})
    library.update({"int8_matmul": lib8, "quantize_int8": None,
                    "dequantize_int8": dequant_t[4]})
    shapes = {name: shape for name in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    shapes.update({
        "int8_matmul": "M={} N={} K={} bf16 out (the fused gate+up)".format(
            *gemm),
        "quantize_int8": f"R={qr} C={qc} bf16",
        "dequantize_int8": f"R={dr} C={dc} -> float32"})
    sources = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:131"),
               "flash_bwd_dq": ("flash_bwd.cu", "flash_attention.py:229"),
               "flash_bwd_dkv": ("flash_bwd.cu", "flash_attention.py:265"),
               "int8_matmul": ("int8_matmul.cu", "int8_matmul.py:130"),
               "quantize_int8": ("quantization.cu", "quantization.py:28"),
               "dequantize_int8": ("quantization.cu", "quantization.py:46")}
    errs = {"flash_fwd": bf16_err, "flash_bwd_dq": bwd_err["dq"],
            "flash_bwd_dkv": bwd_err["dkv"], **int8_errs}
    kernels = []
    for name, (ms, plain, (bound, by)) in timed.items():
        src, ref = sources[name]
        paths = {path: c[name] for path, c in by_path.items() if c[name]}
        if not paths:
            fail(f"{name} launched on no path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_on_k8s_torch/ops/csrc/{src}",
            "replaces": f"tpu_on_k8s/ops/{ref}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library[name],
            "shape": shapes[name]})
        if name in gpt2["d64"]:
            kernels[-1]["gpt2_d64"] = gpt2["d64"][name]
        if name in d256["rows"]:
            kernels[-1]["d256"] = d256["rows"][name]
        if name in phase10["bert_padded"]:
            kernels[-1]["bert_padded_d64"] = phase10["bert_padded"][name]
        if name in phase11["ring_chunk"]:
            kernels[-1]["ring_chunk_d128"] = phase11["ring_chunk"][name]
        if name in phase19["long"]["rows"]:
            kernels[-1]["longcontext"] = phase19["long"]["rows"][name]
        if name == "int8_matmul":
            kernels[-1]["moe_expert"] = phase12["expert_row"]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
