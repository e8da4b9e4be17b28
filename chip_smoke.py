#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port
(``huggingface_sagemaker_tensorflow_distributed_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100: ``sm_90a``) and ``nvcc``.
Imports nothing of JAX or of the JAX package. Phases, in order; any
failure raises and exits non-zero. Phases 5 and 7, the llama cases of
phase 2 and phase 11 (b) time many kernels under ``torch.profiler``, and a
process's profiler drops more of a window's records the more profiled and
traced work the process has run before (none in phase 2, up to three
records in four after the llama phase, and once every record of a kernel
in six windows running): so they run after phase 11's others, each in a
process of its own (``FRESH_PROCESS_PHASES``, ``python3 chip_smoke.py --phase NAME
OUT``), which prints its lines to the same output and hands its rows
back in the JSON file OUT:

1. environment: the card's name and power limit (``nvidia-smi``), the
   CUDA version; TF32 off for matmuls and cuDNN; then every kernel
   source (``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``,
   ``csrc/vocab_ce.cu``) built at once, one ``nvcc`` each; one line per
   kernel (each instance of the paged split and combine kernels, each
   flash and vocab-CE kernel) with its registers and spills (``-Xptxas
   -v``), its shared memory per block and its tensor-core instructions in
   the SASS (``cuobjdump``): the paged kernels (CUDA cores by design) must
   spill nothing; the tensor-core kernels (bf16 flash forward, dQ and
   dK/dV at D 64, 128 and 256) must hold ``HMMA``, the bf16-hidden vocab-CE
   ``wgmma`` kernels (the forward's logits; the backward's dS, dH and dW
   products) ``HGMMA``, and none may spill;
2. kernel: holds the paged decode kernels (the split-context kernel and
   its combine) against ``paged_decode_attention_reference`` on random
   pools with scrambled block tables, ragged contexts including 0 and a
   ``width`` below the table span (GPT-2 shapes, GQA, a sliding window,
   int8 pools, bf16, block sizes 4 and 8, one slot alone at context 1024,
   contexts on and beside the chunk edges under a window that spans
   chunks, and one past the walked width whose band lies wholly beyond
   it; each width of the serve_engine phase's gather ladders, 256 and
   1024 at 8 slots, 128 and 512 at 16 and at 8, and the serve_router
   phase's 128 and 256 at 4 slots, over tables of max_model_len; 16 slots
   whose tables share a 320-token template's
   blocks, fp32 and int8, the template read once in the bound; inputs
   drawn on the card). fp32 and int8 must agree to ``atol = rtol = 1e-4`` on active
   rows, bf16 to ``2e-2``; context-0 rows must be exactly 0. Prints one
   JSON line per case with the kernels' device time (the profiler's,
   split and combine summed per call, median of 5 windows of 20),
   CUDA-event time and the wrapper's host time per call (queued behind a
   spin kernel), the plain version's time,
   ``scaled_dot_product_attention``'s device and event time (inputs
   rotated over four copies so the working set exceeds the 50 MB L2), the
   chunk plan and the bandwidth/compute bound;
3. serve: ``ServeEngine`` on GPT-2 124M at full width (fp32, random
   weights from seed 0) over 20 requests, 16 from ``make_trace`` with
   ``scripts/serve.py``'s defaults and 4 with 512-896-token prompts, at
   the serial engine's settings (``SERVE_SERIAL``: prefix cache and
   overlap off, one width; so are the runs of 3 and 4).
   Requires ``paged_kernel_launches == decode_steps * num_layers`` and
   the engine's tokens equal to the plain ``generate_causal`` on the
   card, up to the first step where the plain path's top-2 logit gap is
   below 1e-3 (a near-tie, counted and printed); then the same trace
   twice more (``serve_sampling_int8_phase``): (i) every other request
   sampled (temperature 0.8, top-p 0.9, its index as seed) on the default
   pool and on a pool that forces preemption: the sampled streams equal
   bit for bit, each sampled token ``sample_per_slot``'s draw on a plain
   forward up to the first near-tie of the noisy warped logits, the greedy
   ones ``generate_causal``'s; (ii) int8 pools: tokens equal
   ``generate_causal`` on the int8 dense cache (near-tie rule), pool bytes
   per token fp32 and int8 and the blocks equal bytes buy; K3 launched 12
   times a decode step in every run;
4. profile: the same trace on a fresh engine under ``torch.profiler``,
   printing device time by kernel and the device's idle share; then
   ``serve_engine``, the engine's single-device features on the same
   model, each run's K3 counts set to 0 just before it and read just
   after (once a layer a decode step; a speculative run launches none),
   telemetry on: (a) the JAX prefix bench's templated trace (48 requests,
   a 320-token template, 16 slots, chunk 32, width 512, 105 blocks) with
   the prefix cache on against off, both primed with the template (TTFT,
   hit rate, blocks saved, copies); (a') copy-on-write held on the card:
   nested templates of 356 and 340 tokens (the shorter ends off the chunk
   grid, so its requests rewrite a block the longer one's hold), 16
   requests, cache on against off, copies above 0; (b) the serve trace on
   the default engine (prefix cache, ladder and overlap on), ladder auto
   against full (switches, read waste, K3 launches by width); (b') the same
   trace on the gather route (``kernel="xla"``, the JAX engine's default:
   no K3 launch), tokens/s and the idle share; (c) speculation in the
   engine, k 4, 4 self-draft layers (acceptance, tokens per target pass);
   (d) the JAX swap bench's thrash trace, swap always against recompute
   (swaps, host bytes, host-tier hits); (e) overlap on against off, every
   other request sampled, no dispatch ahead making the host wait on the
   card (sync debug mode ``error``), the host's wait per step and on a
   second run each the idle share over iterations 8-40; (f) every event
   valid under the port's schema, every ``request_timeline`` summing to its
   e2e, ``policy='slo'`` admitting by deadline. Each pair's tokens must be
   equal, or split only where the plain forward's top-2 gap is below
   1e-3 (sampled: of the noisy warped logits); then ``serve_router``, the
   multi-replica fleet on the same model (every replica on the card with
   K3 and overlap on, K3 counted per replica from each engine's own tally,
   the dispatches ahead and the placement path under sync debug mode
   ``error``): (a) the JAX router bench's accelerator settings (8 slots,
   chunk 32, width 256, 177 blocks a replica), one engine against two
   replicas under ``round_robin``, ``least_loaded`` and ``affinity`` on
   the 48-request mixed trace, and round-robin against affinity on the
   primed templated trace (4 families x 8 behind 96 tokens): tokens equal
   the one engine's up to a near-tie, affinity's hit rate at least
   round-robin's, tokens/s, TTFT, imbalance, peak resident and the idle
   share over fleet iterations 8-40; (b) the affinity fleet drained of
   replica 1 mid-trace (residents migrated live, bytes, restore and hop
   seconds), every request stitched into one complete trace that the
   port's ``check_trace`` passes; (c) ``prefill:1,decode:1`` against two
   mixed replicas (4 slots, 32 requests, prompts 32-128, Poisson 500/s on
   the virtual clock, TTFT SLO 10 ms): tokens equal, no decode step on the
   prefill replica, every request migrated once and stitched complete;
   (d) the open loop (4 slots, 32 requests, virtual 40 and 100000/s, the
   first twice: its summary repeats exactly), then the wall clock at 8, 32
   and 128 requests/s (reported, not gated);
5. flash kernels: holds ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` against their plain versions at the BERT-base shape
   (B 8, H 12, S 512, D 64, a padding mask with ragged lengths) in fp32
   and bf16, and in both dtypes a ragged S 200, causal, causal with
   window 64, a batch row that is all padding and a mask that takes a
   gradient; D 128 in bf16; S 64 and 128 in bf16 with a ragged mask (the data
   phase's bucket widths); in bf16 the encoder tasks' shapes: 16 heads at S
   384 (``qa384_bf16``, BERT-large QA), S 64 and S 512 (``mlm_large_bf16``,
   the BERT-large MLM run), 4 heads at S 512 (ELECTRA-small); the Llama
   and Gemma training shapes (``FLASH_LLAMA``, ``FLASH_GEMMA``: D 256 in
   bf16 and fp32, and D 96 run padded to 128). Error
   bounds (``_limit``): an fp32 output (every output of an fp32 case; LSE
   and dmask of a bf16 one)
   ``1e-4 * max(1, max|want|)`` (the same fp32 arithmetic summed in
   another order, ~1e-6 relative); a bf16 output ``2^-6 * max|want|``
   (one bf16 ulp is at most 2^-7 of a value, both sides round; the kernel
   rounds P against the running max, the plain version against the row
   max). One JSON line per case and kernel with its device time (the
   profiler's, per launch, median of 5 windows of 20), its CUDA-event
   time around a loop of wrapper calls, the plain version's time,
   ``scaled_dot_product_attention``'s device time (forward; backward
   through autograd for the two backward kernels) and the bound;
6. train: (a) one fp32 step (TF32 off, dropout 0) of BERT-base at full
   width on a batch of 8 x 512 vendored reviews, flash kernels against
   the plain attention from the same weights: loss within 1e-5 relative,
   every parameter's gradient within 1e-3 relative L2 (fp32 sums taken in
   other orders through 12 layers) but the key biases', whose exact
   gradient is 0 and whose rounding noise must stay below 1e-5 of the
   global gradient norm on both sides; then one bf16 step the same way
   (the tensor-core kernels): loss within 2^-6 relative of the
   plain bf16 step's, every gradient but the key biases' no further from
   the fp32 plain step's than 2x the plain bf16 step's distance plus 1e-5
   of the global norm (the kernels add no error beyond bf16 rounding), the
   key biases' noise below 2^-10 of the global norm on both sides; the same
   pair of steps, held the same way, for RoBERTa-base, DistilBERT-base,
   ELECTRA-small and ALBERT-base-v2 at their published widths and depth 2
   (ALBERT: its one layer used twice); (b) the training CLI at its defaults
   (bf16 compute, sequence 512, batch 8, eval batch 4, AdamW) from a
   seeded BERT-base on the vendored reviews, with the launch counts
   ``flash_fwd == 12 x (train + eval steps)`` and ``flash_bwd_dq ==
   flash_bwd_dkv == 12 x train steps``, a finite loss, the JAX CLI's
   results-file keys and a ``model.safetensors`` that reloads with
   identical logits; then a short ``torch.profiler`` pass over more train
   steps for the device's idle share, which must name the three bf16
   flash kernels; (c) the training CLI's lifecycle at the same defaults,
   2 epochs of 12 steps, 32 eval samples, checkpoints every 5 steps (2
   kept), keep-best, early stopping (patience 1), ``--profile`` and
   telemetry: an uninterrupted run (async saves), a run stopped after
   epoch 0 step 7 (its last checkpoint is step 5) and its rerun, resumed
   from step 5 (sync saves). The resumed losses must equal the
   uninterrupted run's from step 5 on bit for bit (the K1 kernels use no
   atomics and cuBLAS picks the same algorithms for the same shapes), each
   run's flash launches ``12 x (train + eval steps)`` forward and ``12 x
   train steps`` backward, the profile trace must name the three bf16
   flash kernels, the export must hold the best epoch's weights and give
   the live model's logits, and every event and trace must validate under
   the port's schema. Prints the save stalls (``train/checkpoint`` spans,
   async and sync), the background writes, the restore time, the
   checkpoint's bytes, ``train_mfu`` and ``train_achieved_tflops_per_chip``,
   and each run's split of step wall time between ``train/step_dispatch``,
   ``train/sync`` and ``train/checkpoint`` (the first step's dispatch, which
   builds the kernels, apart); (d) the data stack (``data_phase``): the host
   library built from ``csrc/host`` (its build seconds), a ``vocab.txt`` built
   from the reviews (BERT's specials, the 300 most frequent words, every
   character and ``##`` character), all 5000 reviews tokenized by the C++
   WordPiece and by its Python twin (ids equal exactly; both times and the
   host's CPU printed); run A, the CLI over that WordPiece directory with
   ``--bucket_multiple 64`` and the autotuned prefetch and stager, 40 steps
   and 16 eval steps (launches ``12 x steps``, finite losses; then 6 more
   bucketed steps fed by the pipeline, timed unprofiled and profiled, whose
   profile must name the three bf16 kernels), printing the widths seen, the
   pad waste (real over padded tokens), samples/s, device busy per step, the
   idle share, MFU, the consumer and producer waits and the achieved depth;
   run A', the same with ``HSTD_PREFETCH_AUTOTUNE=0`` for 20 steps, whose
   losses must equal A's bit for bit; run C, ``--streaming true`` without
   bucketing against the same run materialized, 20 steps each, losses equal
   bit for bit; (e) the encoder families and their tasks
   (``encoder_tasks_phase``), each through the training CLI at published
   widths, random weights, bf16 through the flash kernels: BERT-large QA
   (``bert-large-uncased-whole-word-masking`` widths, sequence 384, doc
   stride 128, batch 8, 30 steps, 64 answers decoded over their windows for
   SQuAD's exact match and F1, then 6 more steps timed and profiled for the
   idle share), the same widths at depth 2 on sequence 64 with stride 32
   (contexts split into windows), RoBERTa-base token-cls on the synthetic
   NER (9 labels, sequence 128, 30 steps), DistilBERT-base (30 steps),
   ELECTRA-small and ALBERT-base-v2 (15 steps each) seq-cls on the reviews
   at 512; each run's K1 launches equal its layers (ALBERT: uses of its one
   layer) x its train, eval and QA-eval forwards (backward: x train steps),
   its results files carry the JAX CLI's keys, its losses are finite and
   its export reloads through ``from_pretrained`` to the same eval logits;
   it prints samples/s, step time, MFU and the eval metrics; (f)
   masked-LM and replaced-token-detection pretraining (``mlm_phase``),
   each through the training CLI on the reviews tokenized by a WordPiece
   ``vocab.txt`` built from them, bf16 at the CLI's defaults: BERT-base
   widths ``--task mlm --fused_vocab_ce true`` (30 steps, 16 eval steps:
   K1 and K2 in one step, launches ``flash_fwd == 12 x (train + eval)``,
   ``flash_bwd_* == 12 x train``, ``fused_ce_fwd == train + eval``,
   ``fused_ce_bwd_* == train``; masked tokens a batch, K, and the fused
   loss's own ``ce_dropped`` on every train step, 0 and equal to the
   masked tokens past K; 6 more steps timed and profiled for busy time,
   the idle share, MFU and the K1/K2 kernels), the same unfused (``--fused_vocab_ce false``,
   its first loss within 2^-6 of the fused run's), BERT-large-WWM widths
   fused (10 steps, profiled: K2 at H 1032 on the ``wgmma``
   routes), ELECTRA-small ``--task rtd`` (15 steps,
   detection accuracy) and streaming ``--task mlm`` (10 steps, finite
   losses); each export reloads through ``from_pretrained`` to the same
   logits bit for bit. The train parity phase (a) also holds an fp32 and
   a bf16 MLM step of each of the five families at depth 2 (flash and the
   fused MLM loss against the plain attention and the unfused logits) and
   ELECTRA-small's RTD step, at the same gates (the RTD head's
   one-number bias, like a two-label classifier's, held to the whole
   step's bf16 gate); (g) encoder-decoder seq2seq (``seq2seq_phase``),
   each run through the training CLI with ``--task seq2seq --dataset
   synthetic`` (the CNN/DailyMail-shaped corpus), random weights at
   published widths, bf16, sequence 512, target 64, batch 8, label
   smoothing 0.1: T5-small (``t5-small`` widths) ``--fused_vocab_ce true
   --optimizer adafactor`` (30 steps, 16 eval steps, ROUGE-L of 32 greedy
   summaries; launches ``fused_ce_fwd == train + eval``, ``fused_ce_bwd_*
   == train``, K1 0: T5 attention is the plain one; 6 more steps timed and
   profiled: busy, idle, MFU over encoder and decoder tokens, K2's share),
   the same unfused (30 steps, profiled; its first loss within 2^-6 of the
   fused run's), span corruption (10 steps, target length raised to 106),
   streaming (10 steps, finite losses) and BART-base (``facebook/bart-base``
   widths) fused under AdamW (15 steps, 16 eval steps, ROUGE-L of 16,
   profiled); greedy ``generate`` on the fp32 reload of the first run's
   export equals the argmax of a teacher-forced decode of its own output
   up to the first near-tie (decode tokens/s printed); each export reloads
   through ``from_pretrained(DIR, task="seq2seq")`` to the same logits bit
   for bit. The train parity phase (a) also holds an fp32 and a bf16 step
   of T5-small (v1.0: ReLU, tied head) and BART-base at depth 2, fused
   seq2seq loss (K2 with smoothing 0.1) against the unfused logits, at the
   same gates (every key bias held apart, its exact gradient 0);
7. vocab CE kernels: holds ``fused_ce_fwd``, ``fused_ce_bwd_dh`` and
   ``fused_ce_bwd_dw`` (and the joint ``fused_ce_bwd``, which must equal
   them bit for bit, and itself on a second call, as the forward must
   equal itself on a second call) against their plain
   versions at the GPT-2 causal-LM shape (N 4096 tokens, V 50257, H 768)
   with bf16 hidden and fp32 weight and in fp32, a ragged N 1000 / V 1001,
   H 200 and H 800, label smoothing 0.1, an all-equal W that ties every
   logit (pred must be id 0), and the fused MLM loss's shapes with bf16
   hidden: N 1024, V 30522 at H 776 (BERT-base with the bias folded in)
   and H 1032 (BERT-large; the kernels each wrapper launches are named by
   hidden dtype, ``vocab_kernel_names``), and the eval steps' N 512 at H 776; the
   fused
   seq2seq loss's shapes with bf16 hidden: T5-small's V 32128, H 512 at N
   512 (train, smoothing 0.1) and 256 (eval), span corruption's N 848 and
   424, BART-base's V 50265, H 768 at N 512 and 256. Bound
   ``max|got - want| <= tol * max(1, max|want|)``: tol 1e-4 for fp32 and
   for the loss and LSE (fp32 arithmetic on bf16-exact inputs), 2e-2 for
   dH and dW with bf16 hidden (dH rounded to bf16; dS
   rounded to bf16 before dSᵀ·H, where a last-ulp difference can round
   one step apart). ``pred`` must equal the plain argmax except where the
   plain top-two logit gap is below 1e-5 of the largest logit (counted and
   printed). One JSON line per case and kernel with its device time (the
   profiler's, per call, its helper kernels included, median of 3 windows
   of 5), its CUDA-event time, the plain version's time, the unfused
   library pair's device time (fp32 ``torch.matmul`` with TF32 off plus
   ``cross_entropy``; its autograd backward for dH and dW) and the bound:
   with bf16 hidden the fp32-exact split route's bf16 tensor-core passes
   (``CE_TC_PASSES``; the joint backward 7) at 989 TFLOP/s, the fp32
   CUDA-core bound beside it (``bound_fp32_ms``), the bf16 routes'
   scratch traffic beside that (``scratch_ms``: the forward's split W and
   per-tile statistics, ``_fwd_scratch_bytes``; the backward's split W, dS
   copies and dH partials, ``_bwd_scratch_bytes``); with fp32 hidden the
   fp32 bound. The llama phase's cases add Llama-3's vocab (N 1024,
   V 128256, H 4096), a walk of 13 vocab chunks forward and 26 backward;
8. GPT-2 train: (a) one fp32 step (TF32 off, dropout 0) of GPT-2 124M at
   full width on 8 x 512 vendored reviews, the kernels (flash causal
   attention and the fused vocab CE) against the plain path (plain
   attention, unfused logits and CE) from the same weights: loss within
   1e-5 relative, every parameter's gradient within 1e-3 relative L2
   (a parameter whose exact gradient is 0 is held apart: its noise must
   stay below 1e-5 of the global gradient norm); then one bf16 step (the
   tensor-core flash and vocab-CE kernels) held as the bf16 BERT step is: loss
   within 2^-6 relative of the plain bf16 step's, every gradient no
   further from the fp32 plain step's than 2x the plain bf16 path's
   distance plus 1e-5 of the global norm, the zero-gradient parameters'
   noise below 2^-10 of it; (b) the training CLI with
   ``--task causal-lm --fused_vocab_ce true`` at its defaults from a
   seeded GPT-2 124M, with ``fused_ce_fwd == train + eval steps``,
   ``fused_ce_bwd_dh == fused_ce_bwd_dw == train steps`` and ``flash_fwd
   == 12 x eval steps`` (with attn_pdrop 0.1 the train steps take the
   unfused dropout softmax, as in the JAX package), finite losses, the JAX
   CLI's results-file keys and a ``model.safetensors`` that reloads with
   identical logits; then a short ``torch.profiler`` pass for device time
   by kernel and the idle share, which must name the three K2 kernels;
9. decoding (``decode_phase``): GPT-2 124M from the export of 8 (b), 8
   vendored reviews as right-padded prompts of up to 128 tokens, 64 new
   tokens, fp32 (TF32 off): greedy; sampled (temperature 0.8, top-k 50,
   top-p 0.9) twice with one seed, identical; beam 4 (and beam 1, equal to
   greedy); speculative with ``self_draft(4)``, k 4; chunked prefill (32);
   the int8 KV cache; ``quantize_for_generation`` (logits correlation above
   0.999 and max relative error below 0.05 against fp32, the JAX tests'
   quality contract). Speculative, chunked and beam-1 tokens equal greedy
   up to each row's first near-tie. Each run's TTFT, decode tokens/s, peak
   memory, busy time and idle share; the speculative acceptance rate and
   tokens per target pass; the weight bytes; then the runs again in bf16
   (times only). T5-small and BART-base widths (random, seed 0): greedy,
   sampled, beam 4 (its score at least greedy's), speculative T5 with a
   2-layer draft (tokens equal greedy up to the first near-tie; BART
   refused), the int8 model (its logits' correlation read); tokens/s each.
   The predict CLI in subprocesses started together on the script's
   exports (seq-cls, mlm, causal-lm beam, sampled and self-speculative,
   seq2seq): the JAX rows' keys, generated ids equal to the direct calls';
10. the Llama family and MoE (``llama_phase``), each model's published
   widths written as its ``config.json`` by the script, random weights
   from a seed: (a) Llama-3.1-8B in bf16 built on the card, 8 requests of
   128-512 prompt tokens and 32 new through the engine's defaults (8
   slots, chunk 32, max_model_len 2048) on fp pools, int8 pools and the
   gather route; K3 once a layer a decode step; each run's tokens held to
   the batched plain ``generate_causal`` (dense cache, plain attention;
   int8 on the int8 dense cache) by ``_plain_agreement``: equal up to the
   first step whose plain top-2 gap is below the tie bound, and every
   token, teacher-forced on its own prefix through the plain full
   forward, within the bound of that forward's largest logit (the bound is
   1e-3 in fp32, in bf16 ``BF16_TIE_FACTOR`` times the plain path's own
   noise: its cached decode against its full forward); the gather route
   equal to K3 up to such a tie; (b) Mistral-7B's widths at depth 4, a
   4600-token prompt past its window of 4096 and 32 new tokens, every K3
   call with the window; (c) TinyLlama-1.1B at full depth through the
   train CLI (bf16, batch 4 x 1024 EOS-joined rows, 12 steps): K1 and K2
   counted, samples/s, MFU, busy, idle, K2's share; the fp32 gate at depth
   2 (loss 1e-5 relative and every gradient 1e-3 relative L2 on the first
   step, five AdamW steps' losses 1e-5); (d) Mixtral-8x7B's widths at
   depth 1: five bf16 steps at 2 x 512 through K1 and K2 with the aux
   loss, tokens per expert and capacity drops, the fp32 gate at batch 1,
   and 16 greedy tokens equal to the full forward's argmax at a capacity
   that cannot bind; (e) Gemma-7B at full depth in bf16 (head_dim 256, one
   query head a K/V head) on K3 at D 256: 8 requests of 128-512 prompt
   tokens and 32 new on fp and int8 pools, each held by
   ``_plain_agreement``; (f) Gemma-2B at full depth (MQA, D 256, vocab
   256000, the tied head) through the train CLI as (c), 2 x 1024, 8 steps,
   and its fp32 gate at depth 2 through the fp32 D-256 kernels; its K3
   cases (``llama_kernel_phase``: ``LLAMA_KERNEL_CASES`` and
   ``GEMMA_KERNEL_CASES``), K1 cases (in phase 5) and K2 cases (in phase
   7) run after it in their own processes;
11. the job as the source system launches it: (a) ``launch_phase``: the
   reference's job through ``python -m <port>.launch --slice h100-1``
   (BERT-large-WWM seq-cls at full width and depth, random weights, 30
   steps and 16 eval steps on the vendored reviews), its job directory,
   results, reloaded export, the child's K1 counts from its telemetry and
   wall; then the single-node entry, the learning rate unscaled; (b)
   ``optim_memory_phase`` (its own process, it profiles): AdamW with fp32
   and with bf16 moments, LAMB, and AdamW under remat ``full``, ``dots`` and
   ``dots_no_batch`` on BERT-large-WWM at 8 x 512: peak memory, moment
   bytes (bf16 exactly half), busy, idle, step ms, K1 launches a step
   (the forward twice under remat), the first step's loss equal across
   runs; (c) ``optim_parity_phase``: LAMB and bf16-moment AdamW on the card
   against the CPU on the same parameters and gradients, and an fp32 step
   under each remat policy against the plain step; (d)
   ``optim_resume_phase``: LAMB and bf16-moment AdamW resumed through the
   ``Checkpointer`` bit for bit;
12. telemetry read back (``obs_phase``) with the port's own offline readers
   (``python -m <port>.obs``, in this process): (a) ``report`` and
   ``validate`` over 11 (a)'s job (no schema error, the report valid, the
   child's K1 library load among its compiles, step statistics present);
   (b) ``goodput`` over the serve_router phase's wall-clock open-loop runs
   (each run's attainment the ``OpenLoopDriver``'s own, the JSON the same bytes for
   either order of the inputs); (c) ``slo`` and ``timeline`` over the
   serve_engine phase's timelines, the Chrome trace parsed back; (d)
   ``trace`` and ``fleet`` over the serve_router drain (every trace
   complete, one a request); (e) in a process of its own
   (``compile_budget_phase``) BERT-base seq-cls at full width and depth
   through the training CLI with ``--bucket_multiple 64`` and
   ``HSTD_COMPILE_BUDGET_S=0``: one ``compile_budget`` alert, and after it
   no width the batcher had not cut before but the full one; the build of
   phase 1 counts its ``nvcc`` builds and their seconds through a compile
   tracker (f);
13. each phase's wall seconds, the ``kernels`` line (the paged kernel's
   ``launches_by_path``, its launches by width in the serve_engine runs and
   by replica and width in the serve_router runs, and its ladder and
   shared-block cases; the llama phase's launches and cases beside), the
   card's line, and the final ``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "huggingface_sagemaker_tensorflow_distributed_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/paged_attention.cu"
KERNEL_REPLACES = ("huggingface_sagemaker_tensorflow_distributed_tpu/ops/"
                   "pallas_paged_attention.py:67")
# the kernels each paged call launches once each (the first is the one its
# device time is counted by): the split-context kernel and its combine
PAGED_KERNEL_NAMES = ("paged_decode_split_kernel", "paged_decode_combine_kernel")
FLASH_SOURCE = f"{PKG}/csrc/flash_attention.cu"
FLASH_TC_SOURCE = f"{PKG}/csrc/flash_attention_tc.cuh"
_PALLAS_ATTN = "huggingface_sagemaker_tensorflow_distributed_tpu/ops/pallas_attention.py"
FLASH_REPLACES = {"flash_fwd": f"{_PALLAS_ATTN}:65",
                  "flash_bwd_dq": f"{_PALLAS_ATTN}:195",
                  "flash_bwd_dkv": f"{_PALLAS_ATTN}:246"}
VOCAB_SOURCE = f"{PKG}/csrc/vocab_ce.cu"
VOCAB_FWD_SOURCE = f"{PKG}/csrc/vocab_ce_fwd.cuh"
VOCAB_BWD_SOURCE = f"{PKG}/csrc/vocab_ce_bwd.cuh"
_PALLAS_CE = "huggingface_sagemaker_tensorflow_distributed_tpu/ops/pallas_vocab_ce.py"
VOCAB_REPLACES = {"fused_ce_fwd": f"{_PALLAS_CE}:48",
                  "fused_ce_bwd_dh": f"{_PALLAS_CE}:166",
                  "fused_ce_bwd_dw": f"{_PALLAS_CE}:202"}
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, fp32 (non-tensor-core) and
# dense bf16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
NEAR_TIE = 1e-3
# the profiled windows' marker kernels: 32 spins of about 1.25 ms each at
# the H100's clock
MARKER_CYCLES = 80_000_000
MARKER_KERNELS = 32
# the spin that holds the card while ``_host_ms`` times a loop of calls:
# about 100 ms at the H100's clock
HOST_SPIN_CYCLES = 200_000_000
# profiled windows (and host-timed loops) a kernel time is the median of:
# three keeps the whole script inside its time limit
TIMING_REPEATS = 3
# where the kernel, flash and train phases run; "cpu" only to rehearse
# them at a small size (every wrapper then takes its plain version)
DEVICE = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# -- phase 1 -----------------------------------------------------------------

def _no_tf32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def env_phase() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed no card")
    _no_tf32()
    emit({"phase": "env", "card": smi[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    return smi[0]


# -- phase 2 -----------------------------------------------------------------

KERNEL_CASES = [
    # name, slots, Hq, Hkv, D, block_size, max context, dtype, int8, window,
    # contexts: "ragged" (0, the max, the rest random), "full" (every slot
    # at the max), "chunk_edges" (0, 1, chunk - 1, chunk, chunk + 1,
    # 2 chunk and the max, for the chunk the plan picks, and the max plus
    # the window: past the walked width, its band wholly beyond it)
    ("gpt2", 8, 12, 12, 64, 16, 1024, "float32", False, None, "ragged"),
    ("gqa", 8, 32, 8, 128, 16, 1024, "float32", False, None, "ragged"),
    ("window64", 8, 12, 12, 64, 16, 1024, "float32", False, 64, "ragged"),
    ("int8", 8, 12, 12, 64, 16, 1024, "float32", True, None, "ragged"),
    ("bf16", 8, 12, 12, 64, 16, 1024, "bfloat16", False, None, "ragged"),
    ("int8_bf16", 8, 32, 8, 128, 16, 1024, "bfloat16", True, None, "ragged"),
    ("bs4_gqa", 4, 8, 2, 128, 4, 200, "float32", False, 24, "ragged"),
    ("bs8", 4, 12, 12, 64, 8, 300, "float32", False, None, "ragged"),
    # one request decoding alone: the grid must still reach every SM
    ("single", 1, 12, 12, 64, 16, 1024, "float32", False, None, "full"),
    # contexts on and beside the chunk edges, a window across them
    ("chunk_edges", 8, 12, 12, 64, 16, 1024, "float32", False, 200, "chunk_edges"),
    # the serve_engine phase's launch configurations: each width of the
    # gather ladder (the 20-request trace's 256 and 1024 at 8 slots, the
    # prefix trace's 128 and 512 at 16, the thrash trace's at 8), over
    # tables of max_model_len
    # (TABLE_BLOCKS), and 16 slots whose tables share a 320-token
    # template's blocks, as the prefix cache makes them, fp and int8
    ("serve_w256", 8, 12, 12, 64, 16, 256, "float32", False, None, "ragged"),
    ("serve_w1024", 8, 12, 12, 64, 16, 1024, "float32", False, None, "ragged"),
    ("prefix_w128", 16, 12, 12, 64, 16, 128, "float32", False, None, "ragged"),
    ("prefix_w512", 16, 12, 12, 64, 16, 512, "float32", False, None, "ragged"),
    ("thrash_w128", 8, 12, 12, 64, 16, 128, "float32", False, None, "ragged"),
    ("thrash_w512", 8, 12, 12, 64, 16, 512, "float32", False, None, "ragged"),
    ("shared", 16, 12, 12, 64, 16, 512, "float32", False, None, "shared"),
    ("shared_int8", 16, 12, 12, 64, 16, 512, "float32", True, None, "shared"),
    # the serve_router phase's 4-slot engines (the roles and open-loop
    # fleets) at each width of their ladder [128, 256], tables of 256
    ("router_w128", 4, 12, 12, 64, 16, 128, "float32", False, None, "ragged"),
    ("router_w256", 4, 12, 12, 64, 16, 256, "float32", False, None, "ragged"),
    # the llama phase's launch configurations: Llama-3.1-8B's GQA (32 query
    # heads over 8 K/V heads, D 128) at each width of its serve run's
    # ladder over bf16 and int8 pools, tables of max_model_len 2048;
    # TinyLlama's 8 query heads a K/V head at D 64; Qwen2's 7 (14 over 2:
    # the kernel rounds the group to 8 slots, one lane idle); Mistral-7B's
    # window of 4096 on contexts around it at the window run's width
    ("llama3_8b_w512", 8, 32, 8, 128, 16, 512, "bfloat16", False, None, "ragged"),
    ("llama3_8b_w2048", 8, 32, 8, 128, 16, 2048, "bfloat16", False, None, "ragged"),
    ("llama3_8b_int8_w512", 8, 32, 8, 128, 16, 512, "bfloat16", True, None, "ragged"),
    ("llama3_8b_int8_w2048", 8, 32, 8, 128, 16, 2048, "bfloat16", True, None, "ragged"),
    ("tinyllama", 8, 32, 4, 64, 16, 1024, "bfloat16", False, None, "ragged"),
    ("qwen2_g7", 8, 14, 2, 64, 16, 1024, "bfloat16", False, None, "ragged"),
    ("mistral_window", 4, 32, 8, 128, 16, 4736, "bfloat16", False, 4096, "listed"),
    # the Gemma runs' launch configurations at head_dim 256: Gemma-7B's one
    # query head a K/V head (16 over 16) at each width of its serve run's
    # ladder over bf16 and int8 pools, tables of max_model_len 2048;
    # Gemma-2B's MQA (8 query heads over 1, the kernel's widest group);
    # each group width once over fp32 pools
    ("gemma7b_w512", 8, 16, 16, 256, 16, 512, "bfloat16", False, None, "ragged"),
    ("gemma7b_w2048", 8, 16, 16, 256, 16, 2048, "bfloat16", False, None, "ragged"),
    ("gemma7b_int8_w512", 8, 16, 16, 256, 16, 512, "bfloat16", True, None, "ragged"),
    ("gemma7b_int8_w2048", 8, 16, 16, 256, 16, 2048, "bfloat16", True, None, "ragged"),
    ("gemma2b_mqa", 8, 8, 1, 256, 16, 1024, "bfloat16", False, None, "ragged"),
    ("gemma7b_fp32", 8, 16, 16, 256, 16, 512, "float32", False, None, "ragged"),
    ("gemma2b_mqa_fp32", 8, 8, 1, 256, 16, 1024, "float32", False, None, "ragged"),
]
# a "listed" case's contexts
LISTED_CONTEXTS = {"mistral_window": [4095, 4096, 4097, 4700]}
LLAMA_KERNEL_CASES = ("llama3_8b_w512", "llama3_8b_w2048", "llama3_8b_int8_w512",
                      "llama3_8b_int8_w2048", "tinyllama", "qwen2_g7", "mistral_window")
# the llama serve run's ladder cases by (slots, width, int8)
LLAMA_LADDER_CASES = {(8, 512, False): "llama3_8b_w512", (8, 2048, False): "llama3_8b_w2048",
                      (8, 512, True): "llama3_8b_int8_w512",
                      (8, 2048, True): "llama3_8b_int8_w2048"}
GEMMA_KERNEL_CASES = ("gemma7b_w512", "gemma7b_w2048", "gemma7b_int8_w512",
                      "gemma7b_int8_w2048", "gemma2b_mqa", "gemma7b_fp32", "gemma2b_mqa_fp32")
# the Gemma-7B serve run's ladder cases by (slots, width, int8)
GEMMA_LADDER_CASES = {(8, 512, False): "gemma7b_w512", (8, 2048, False): "gemma7b_w2048",
                      (8, 512, True): "gemma7b_int8_w512",
                      (8, 2048, True): "gemma7b_int8_w2048"}
# block-table columns of a case (else the walked blocks plus 4): the
# engine's tables hold max_model_len // block_size columns whatever width
# the ladder walks
TABLE_BLOCKS = {"serve_w256": 64, "serve_w1024": 64, "prefix_w128": 32,
                "prefix_w512": 32, "thrash_w128": 32, "thrash_w512": 32, "shared": 32,
                "shared_int8": 32, "router_w128": 16, "router_w256": 16,
                "llama3_8b_w512": 128, "llama3_8b_w2048": 128, "llama3_8b_int8_w512": 128,
                "llama3_8b_int8_w2048": 128, "mistral_window": 296, "gemma7b_w512": 128,
                "gemma7b_w2048": 128, "gemma7b_int8_w512": 128, "gemma7b_int8_w2048": 128}
SHARED_PREFIX = 320             # the shared cases' template tokens (20 blocks)
# the ladders' cases by (slots, width), as the serve_engine and
# serve_router phases run them (the plan follows slots and width; the
# router's 8-slot placement fleets walk 128 and 256 as the thrash and
# serve engines do)
LADDER_CASES = {(8, 256): "serve_w256", (8, 1024): "serve_w1024",
                (16, 128): "prefix_w128", (16, 512): "prefix_w512",
                (8, 128): "thrash_w128", (8, 512): "thrash_w512",
                (4, 128): "router_w128", (4, 256): "router_w256"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COPIES = 4          # distinct input sets the timing rotates over
# a bf16 output of the flash and vocab-CE kernels is held to 2^-6 of
# max|want| with no floor of 1: one bf16 ulp is at most 2^-7 of a value,
# and both sides round their output once
BF16_TOL = 2.0 ** -6


def _limit(got, want_max: float) -> float:
    """The largest |got - want| allowed for a flash or vocab-CE output: a
    bf16 output ``BF16_TOL``·max|want|; an fp32 output (fp32 arithmetic on
    the same inputs: the flash LSE and dmask, the CE loss, LSE and dW, and
    every output of an fp32 case) 1e-4·max(1, max|want|)."""
    import torch

    if got.dtype == torch.bfloat16:
        return BF16_TOL * want_max
    return TOL["float32"] * max(1.0, want_max)


def _sms() -> int:
    """The SMs the paged wrapper plans for: the card's (the H100's 132 when
    rehearsed on the CPU)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa

    return pa._sm_count(0) if DEVICE == "cuda" else pa.H100_SMS


def _plan(case) -> tuple[int, int]:
    """The (chunk, chunks) the paged wrapper's plan picks for a case."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa

    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window, kind = case
    width = -(-max_ctx // bs) * bs
    return pa.split_plan(S, Hkv, min(width, window) if window else width, bs, _sms())


def _contexts(case, gen) -> list[int]:
    """The case's contexts (see ``KERNEL_CASES``)."""
    import torch

    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window, kind = case
    if kind == "full":
        return [max_ctx] * S
    if kind == "listed":
        return list(LISTED_CONTEXTS[name])
    if kind == "chunk_edges":
        c = _plan(case)[0]
        return [0, 1, c - 1, c, c + 1, 2 * c, max_ctx, max_ctx + (window or bs)][:S]
    if kind == "shared":
        # the template, a tail and a few generated tokens each
        return (SHARED_PREFIX + 1 + torch.randint(
            0, max_ctx - SHARED_PREFIX, (S,), generator=gen, device=gen.device)).tolist()
    rest = torch.randint(1, max_ctx, (S - 2,), generator=gen, device=gen.device).tolist()
    return [0, max_ctx] + rest


def _make_inputs(case, gen, device):
    """A case's inputs drawn on ``gen``'s device (the kernel phases' is the
    card's: the Gemma pools alone are 0.5 G values, about 5 s a case on the
    host) and moved to ``device``."""
    import torch

    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window, kind = case
    dtype = getattr(torch, dt)
    on = dict(generator=gen, device=gen.device)
    nb_walk = -(-max_ctx // bs)
    nb_table = TABLE_BLOCKS.get(name, nb_walk + 4)   # width below the span
    N = 1 + S * nb_table
    tables = (torch.randperm(N - 1, **on) + 1)[: S * nb_table]
    tables = tables.reshape(S, nb_table).to(torch.int32)
    if kind == "shared":
        tables[:, :SHARED_PREFIX // bs] = tables[0, :SHARED_PREFIX // bs].clone()
    ctx = torch.tensor(_contexts(case, gen), dtype=torch.int32)
    q = torch.randn(S, Hq, D, **on).to(dtype)
    if int8:
        k = torch.randint(-127, 128, (N, bs, Hkv, D), **on).to(torch.int8)
        v = torch.randint(-127, 128, (N, bs, Hkv, D), **on).to(torch.int8)
        ks = torch.rand(N, bs, Hkv, 1, **on) * 0.02 + 1e-3
        vs = torch.rand(N, bs, Hkv, 1, **on) * 0.02 + 1e-3
    else:
        k = torch.randn(N, bs, Hkv, D, **on).to(dtype)
        v = torch.randn(N, bs, Hkv, D, **on).to(dtype)
        ks = vs = None
    t = dict(q=q, k_pool=k, v_pool=v, block_tables=tables, context_lens=ctx,
             k_scale_pool=ks, v_scale_pool=vs)
    t = {key: (val.to(device) if val is not None else None)
         for key, val in t.items()}
    return t, dict(width=nb_walk * bs, window=window)


def _work(case, ctx: list[int]) -> tuple[int, int]:
    """(bytes, flops) the function needs for these contexts: q and out
    once, each valid key's K and V row once (plus its scales; a block
    that several slots share once), the table entries walked and the
    context lengths."""
    name, S, Hq, Hkv, D, bs, max_ctx, dt, int8, window, kind = case
    esz = 2 if dt == "bfloat16" else 4
    kv_esz = 1 if int8 else esz
    width = -(-max_ctx // bs) * bs
    spans = [(max(0, c - window) if window else 0, min(c, width)) for c in ctx]
    keys = sum(max(0, hi - lo) for lo, hi in spans)
    read = keys
    if kind == "shared":
        # the template's K/V is one input, however many slots read it
        read -= (len(ctx) - 1) * SHARED_PREFIX
    table_entries = sum(max(0, -(-hi // bs) - lo // bs) for lo, hi in spans)
    bytes_ = (2 * S * Hq * D * esz                   # q in, out
              + read * Hkv * (2 * D * kv_esz + (8 if int8 else 0))
              + table_entries * 4 + S * 4)
    flops = keys * Hq * D * 4                        # q.k and p.v
    return bytes_, flops


def _cuda_ms(fn, arg_sets, iters: int = 40) -> float:
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, arg_sets, match: str | tuple | None = None, iters: int = 20,
               repeats: int = TIMING_REPEATS) -> float:
    """Device time per call over ``repeats`` profiled windows of ``iters``
    calls each. With ``match`` (a name, a tuple of the names of the kernels
    each call launches once each, or a dict of each name's launches a call)
    the median over the windows of the sum over the names of the mean
    device time of that name's records times its launches a call; with
    None, every device activity of the windows, each record name counted
    as ``_pooled_ms`` does.
    Unlike ``_cuda_ms`` it holds no host gap between launches. Each window
    opens with ``MARKER_KERNELS`` marker kernels that spin for about 40 ms
    in all (``torch.cuda._sleep``; their spin kernels are left out of the
    sums): the profiler can lose the records of the kernels that run while
    it is still starting to record, and the more so after many earlier
    profiler sessions in the process (a marker of 1000 cycles still lost
    one call in five of the K2 kernels; after the serve profile's long
    window every later window lost its first two records; after the
    lifecycle phase's profiled fits a window of 10 ms of markers lost one
    vocab-CE call in five). A record the profiler still drops costs that
    name one sample of its mean, not a call's time in the sum: such a loss
    is printed as a ``profiler_loss`` line. A window that holds no record
    of a name, more records of one than ``iters`` calls launch, or no
    device time, is taken again, up to ``repeats`` times in all."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    # each name with its launches a call (1 unless a dict gives them)
    counts = (None if match is None else {match: 1} if isinstance(match, str)
              else dict(match) if isinstance(match, dict) else dict.fromkeys(match, 1))
    per_call, windows, short, lost = [], [], 0, 0
    while len(per_call) + len(windows) < repeats:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKER_KERNELS):
                torch.cuda._sleep(MARKER_CYCLES // MARKER_KERNELS)
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        if counts is None:
            records = {k: v for k, v in _device_records(prof).items() if "spin_kernel" not in k}
            if records:
                windows.append(records)
                continue
            held = [0]
        else:
            # records and seconds by name straight off the kineto results
            # (``key_averages`` gives the same counts after building its
            # event tree, seconds of host time a window)
            records = _device_records(prof)
            held = [sum(c for k, (_, c) in records.items() if n in k) for n in counts]
            secs = [sum(t for k, (t, _) in records.items() if n in k) for n in counts]
            if (all(0 < c <= iters * k for c, k in zip(held, counts.values()))
                    and all(t > 0 for t in secs)):
                per_call.append(sum(t / c * k for t, c, k in zip(secs, held, counts.values()))
                                * 1e3)
                lost += iters * sum(counts.values()) - sum(held)
                continue
        short += 1
        check(short <= repeats, f"{short} profiled windows held {held} of {iters} "
                                f"launches of {match or 'the call'}")
    if windows:
        ms, lost = _pooled_ms(windows, iters)
    else:
        ms = statistics.median(per_call)
    if lost:
        emit({"phase": "profiler_loss", "kernels": list(counts or ("the call",)),
              "windows": repeats, "iters": iters, "records_lost": lost})
    return ms


def _host_ms(fn, arg_sets, iters: int = 100, repeats: int = TIMING_REPEATS) -> float:
    """Host time per call: the median over ``repeats`` loops of ``iters``
    calls on the host's clock, each loop queued behind a spin kernel of
    about 100 ms, so that every launch only queues and the time is the
    wrapper's own host work (checks, plan, allocations, launches). Fails
    if a loop outlasts its spin."""
    import statistics
    import time

    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        spun = torch.cuda.Event()
        spun.record()
        start = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        per_call.append((time.perf_counter() - start) / iters * 1e3)
        check(not spun.query(), f"{iters} calls outlasted a spin of {HOST_SPIN_CYCLES} cycles")
        torch.cuda.synchronize()
    return statistics.median(per_call)


def _sdpa_inputs(t, opts):
    """The same attention as dense tensors for one
    ``scaled_dot_product_attention`` call: gathered (dequantized, GQA
    repeated) KV and a boolean context/band mask. Built outside the
    timed call."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
        gather_paged_kv,
    )

    q = t["q"]
    k = gather_paged_kv(t["k_pool"], t["block_tables"], opts["width"])
    v = gather_paged_kv(t["v_pool"], t["block_tables"], opts["width"])
    if t["k_scale_pool"] is not None:
        k = (k.float() * gather_paged_kv(t["k_scale_pool"], t["block_tables"],
                                         opts["width"])).to(q.dtype)
        v = (v.float() * gather_paged_kv(t["v_scale_pool"], t["block_tables"],
                                         opts["width"])).to(q.dtype)
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).contiguous()
    v = v.repeat_interleave(rep, dim=1).contiguous()
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    ctx = t["context_lens"].long()[:, None]
    keep = pos < ctx
    if opts["window"]:
        keep = keep & (pos > ctx - 1 - opts["window"])
    keep[:, 0] |= ~keep.any(-1)          # context-0 rows: any finite row
    return q[:, :, None, :], k, v, keep[:, None, None, :]


def kernel_phase(cases=None) -> dict:
    """Each paged case (``cases``, else ``KERNEL_CASES``): the kernels
    against the plain version, their device time (profiler, both kernels
    summed) and CUDA-event time, the plain version's,
    ``scaled_dot_product_attention``'s device and event time, and the
    bound."""
    import torch
    import torch.nn.functional as F

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa

    pa.load_kernel()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for case in KERNEL_CASES if cases is None else cases:
        name, dt = case[0], case[7]
        sets = [_make_inputs(case, gen, dev) for _ in range(COPIES)]
        t, opts = sets[0]
        want = pa.paged_decode_attention_reference(**t, **opts)
        args = [tuple(s[0].values()) + (s[1]["width"], s[1]["window"]) for s in sets]
        got = pa.paged_decode_attention(**t, **opts)
        _sync()
        tol = TOL[dt]
        ctx = t["context_lens"].cpu()
        act = ctx > 0
        g, w = got.float().cpu(), want.float().cpu()
        err = float((g[act] - w[act]).abs().max())
        ok = (torch.allclose(g[act], w[act], atol=tol, rtol=tol)
              and bool((g[~act] == 0).all()) and bool(torch.isfinite(g).all()))
        check(ok, f"kernel case {name}: max_abs_err {err} (tol {tol}) or a "
                  "context-0 row is not exactly 0")

        def kern(q, kp, vp, bt, cl, ksp, vsp, width, window):
            pa.paged_decode_attention(q, kp, vp, bt, cl, width=width, window=window,
                                      k_scale_pool=ksp, v_scale_pool=vsp)

        def plain(q, kp, vp, bt, cl, ksp, vsp, width, window):
            pa.paged_decode_attention_reference(q, kp, vp, bt, cl, width=width,
                                                window=window, k_scale_pool=ksp,
                                                v_scale_pool=vsp)

        def sdpa(q, k, v, m):
            F.scaled_dot_product_attention(q, k, v, attn_mask=m)

        dense = [_sdpa_inputs(*s) for s in sets]
        ms = _device_ms(kern, args, PAGED_KERNEL_NAMES)
        event_ms = _cuda_ms(kern, args)
        host_ms = _host_ms(kern, args)
        plain_ms = _cuda_ms(plain, args)
        library_ms = _device_ms(sdpa, dense)
        library_event_ms = _cuda_ms(sdpa, dense)
        nbytes, flops = _work(case, ctx.tolist())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        S, Hkv, window = case[1], case[3], case[9]
        width = opts["width"]
        chunk, chunks = _plan(case)
        # the split blocks that hold keys: each slot's band in chunks
        spans = [min(c, width) - (max(0, c - window) if window else 0) for c in ctx.tolist()]
        with_keys = Hkv * sum(-(-n // chunk) for n in spans if n > 0)
        if case[10] == "full":
            check(with_keys >= _sms(), f"kernel case {name}: {with_keys} blocks hold keys, "
                                       f"fewer than the {_sms()} SMs")
        row = {"phase": "kernel", "case": name, "slots": S, "hq": case[2],
               "hkv": Hkv, "head_dim": case[4], "block_size": case[5],
               "dtype": dt, "int8": case[8], "window": window,
               "contexts": ctx.tolist(), "width": width, "chunk": chunk,
               "grid_blocks": Hkv * S * chunks, "blocks_with_keys": with_keys,
               "max_abs_err": err, "tol": tol, "status": "pass",
               "kernel_ms": ms, "kernel_event_ms": event_ms, "kernel_host_ms": host_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms, "library_event_ms": library_event_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        emit(row)
        results[name] = row
        del sets, dense, args
    return results


# -- phase 3 -----------------------------------------------------------------

SERVE_CONFIG: dict = {}         # Gpt2Config overrides: none, GPT-2 124M
SERVE_MAX_LEN = 1024
SERVE_LONG_PROMPTS = (512, 897)  # the 4 long requests' prompt lengths
SERVE_TIGHT_BLOCKS = 1 + 72      # a pool two long requests overflow: preemption
SERVE_SAMPLING = dict(temperature=0.8, top_p=0.9)   # every other request, seed = its index


def serve_trace(vocab: int = 50257):
    import numpy as np

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import (
        make_trace,
    )

    rng = np.random.RandomState(0)
    vocab = vocab - 1
    # scripts/serve.py's synthetic defaults: prompts 8-48, max_new 64
    trace = make_trace(rng, 16, vocab, 8, 48, (4, 16), (32, 64), long_every=4)
    for _ in range(4):              # long prompts: decode walks up to 60 blocks
        p = int(rng.randint(*SERVE_LONG_PROMPTS))
        trace.append((rng.randint(1, vocab, (p,)).astype(np.int32),
                      int(rng.randint(32, 65))))
    return trace


# the serve, sampled, int8 and profile runs keep the serial engine they
# measured before the prefix cache, the width ladder and the overlap loop
# were ported (the serve_engine phase runs the new defaults beside them)
SERVE_SERIAL = dict(prefix_cache="off", overlap="off", gather_buckets="full")


def serve_engine(model, num_blocks: int | None = None, **kw):
    """The serve phase's engine: 8 slots, block 16, chunk 16, prefill
    batch 4, max_model_len 1024 and ``scripts/serve.py``'s default pool
    of 3/4 of slots x max_model_len (``num_blocks`` or ``kw`` override),
    at ``SERVE_SERIAL`` unless ``kw`` sets those knobs."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        ServeEngine,
    )

    max_len, bs, slots = SERVE_MAX_LEN, 16, 8
    if num_blocks is None and "kv_pool_bytes" not in kw:
        num_blocks = 1 + slots * (max_len // bs) * 3 // 4
    return ServeEngine(model, num_slots=slots, block_size=bs,
                       num_blocks=num_blocks or 2, prefill_chunk=16, prefill_batch=4,
                       max_model_len=max_len, device=DEVICE, **{**SERVE_SERIAL, **kw})


def _counted_serve(engine, trace, sampling=None) -> tuple:
    """Submit ``trace`` (``sampling[i]``: request i's sampling knobs), run
    the engine with the paged kernel's count set to 0 just before:
    ``(requests, wall seconds, launches)``; checks the launches equal
    decode steps x layers."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    sampling = sampling or [{}] * len(trace)
    reqs = [engine.submit(p, m, **kw) for (p, m), kw in zip(trace, sampling)]
    paged_decode_attention.launches = 0
    _sync()
    t0 = time.perf_counter()
    engine.run()
    _sync()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    stats = engine.stats()
    layers = engine.model.config.num_layers
    check(stats.decode_steps > 0 and launches > 0, "no decode step ran the kernel")
    check(launches == stats.decode_steps * layers and stats.paged_kernel_launches == launches,
          f"paged_kernel_launches {launches} != decode_steps {stats.decode_steps} x {layers}")
    check(len(engine.finished) == len(trace), "not every request finished")
    return reqs, wall, launches


def _greedy_agreement(model, engine, trace, reqs, skip=()) -> tuple[int, int]:
    """Each greedy request's tokens against the plain ``generate_causal``
    of ``model`` (its own KV storage), up to the first step where the plain
    path's top-2 logit gap is below ``NEAR_TIE``: ``(tokens compared, near
    ties)``. Requests whose index is in ``skip`` are left out."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    eos = model.config.eos_token_id
    near_ties = compared = 0
    for i, ((prompt, max_new), req) in enumerate(zip(trace, reqs)):
        if i in skip:
            continue
        got = [int(x) for x in engine.output_ids(req)]
        ids, scores = generate_causal(model, torch.as_tensor(prompt, device=DEVICE)[None],
                                      max_new_tokens=max_new, output_scores=True)
        check(bool(torch.isfinite(scores).all()), f"request {req.rid}: "
              "non-finite logits on the plain path")
        ref = ids[0].tolist()
        if eos in ref:
            ref = ref[:ref.index(eos) + 1]
        top2 = scores[0, :len(ref)].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        n = next((j for j, gp in enumerate(gaps) if gp < NEAR_TIE), len(ref))
        near_ties += n < len(ref)
        # tokens must agree before the first near-tie step; after it the
        # paths may legitimately split
        check(len(got) == len(ref) or n < len(ref),
              f"request {req.rid}: engine emitted {len(got)} tokens, plain path {len(ref)}")
        check(got[:n] == ref[:n], f"request {req.rid}: engine tokens differ from plain "
              f"generate_causal before any near-tie (engine {got[:n]}, plain {ref[:n]})")
        compared += n
    return compared, near_ties


def _sampled_agreement(model, engine, trace, reqs, sampling) -> tuple[int, int]:
    """Each sampled request's tokens against ``sample_per_slot`` on a plain
    full forward of its prompt and the tokens before, at its (seed, token
    index), up to the first step where the warped logits plus the draw's
    noise have a top-2 gap below ``NEAR_TIE``: ``(tokens compared, near
    ties)``."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen

    near_ties = compared = 0
    for (prompt, _), req, kw in zip(trace, reqs, sampling):
        if not kw:
            continue
        out = [int(x) for x in engine.output_ids(req)]
        seq = torch.as_tensor(list(prompt) + out, device=DEVICE)[None]
        with torch.inference_mode():
            logits = model(seq)[0, len(prompt) - 1:-1].float()
        n_tok = logits.shape[0]
        full = lambda v: torch.full((n_tok,), v, device=DEVICE)   # noqa: E731
        warped = gen.warp_logits_per_slot(logits, full(kw["temperature"]),
                                          full(kw.get("top_k", 0)).long(),
                                          full(kw.get("top_p", 0.0)))
        noisy = warped + gen._slot_gumbel(full(kw["seed"]).long(),
                                          torch.arange(n_tok, device=DEVICE), logits.shape[-1])
        top2 = noisy.topk(2, dim=-1).values
        want = noisy.argmax(-1).tolist()
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        n = next((j for j, gp in enumerate(gaps) if gp < NEAR_TIE), n_tok)
        near_ties += n < n_tok
        check(out[:n] == want[:n], f"request {req.rid}: sampled tokens differ from the plain "
              f"draw before any near-tie (engine {out[:n]}, plain {want[:n]})")
        compared += n
    return compared, near_ties


def serve_phase() -> tuple[dict, object, list]:
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_gpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        Gpt2Config,
    )

    cfg = Gpt2Config(hidden_dropout=0.0, embd_dropout=0.0, attention_dropout=0.0,
                     **SERVE_CONFIG)
    model = init_gpt2(cfg, seed=0, device=DEVICE)
    engine = serve_engine(model)
    trace = serve_trace(cfg.vocab_size)
    reqs, wall, launches = _counted_serve(engine, trace)
    stats = engine.stats()
    t1 = time.perf_counter()
    compared, near_ties = _greedy_agreement(model, engine, trace, reqs)
    plain_s = time.perf_counter() - t1
    slo = engine.slo_summary()
    tokens = sum(len(engine.output_ids(r)) for r in reqs)
    row = {"phase": "serve", "model": "gpt2-124m", "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "vocab": cfg.vocab_size, "dtype": "float32",
           "requests": len(reqs), "tokens": tokens,
           "tokens_per_sec": tokens / wall, "wall_s": wall,
           "ttft_p50_s": slo.get("ttft_p50_s"), "ttft_p99_s": slo.get("ttft_p99_s"),
           "e2e_p50_s": slo.get("e2e_p50_s"), "e2e_p99_s": slo.get("e2e_p99_s"),
           "decode_steps": stats.decode_steps,
           "decode_tokens_per_sec": slo.get("decode_tokens_per_sec"),
           "prefill_dispatches": stats.prefill_dispatches,
           "preemptions": stats.preemptions,
           "kv_peak_utilization": stats.kv_peak_utilization,
           "paged_kernel_launches": launches,
           "tokens_compared_with_plain": compared, "near_ties": near_ties,
           "plain_generate_s": plain_s}
    emit(row)
    return row, model, trace


def _kv_twin(model, kv_cache_dtype: str):
    """``model`` with another KV storage, sharing its tensors."""
    import dataclasses

    import torch

    with torch.device("meta"):
        twin = type(model)(dataclasses.replace(model.config, kv_cache_dtype=kv_cache_dtype))
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval()


def serve_sampling_int8_phase(model, trace, kernels: dict) -> dict:
    """The serve trace twice more: (i) every other request sampled
    (``SERVE_SAMPLING``, seed = its index) on the default pool and on a
    pool that forces preemption: the sampled streams must be the same bit
    for bit, each sampled token ``sample_per_slot``'s draw on a plain
    forward, the greedy ones ``generate_causal``'s (near-tie rule); (ii)
    int8 pools (``kv_cache_dtype='int8'``, K3's int8 route): tokens equal
    ``generate_causal`` on the int8 dense cache (near-tie rule); pool bytes
    per token fp and int8 and what each admits on equal bytes. Each run's
    K3 launches are decode steps x layers."""
    sampling = [dict(SERVE_SAMPLING, seed=i) if i % 2 else {} for i in range(len(trace))]
    runs, rows = {}, {}
    for name, blocks in (("sampled", None), ("sampled_tight", SERVE_TIGHT_BLOCKS)):
        engine = serve_engine(model, num_blocks=blocks)
        reqs, wall, launches = _counted_serve(engine, trace, sampling)
        runs[name] = (engine, reqs)
        stats = engine.stats()
        tokens = sum(len(engine.output_ids(r)) for r in reqs)
        rows[name] = {"phase": "serve_sampled", "run": name, "requests": len(reqs),
                      "sampled_requests": sum(1 for kw in sampling if kw),
                      "sampling": SERVE_SAMPLING, "num_blocks": engine.blocks.num_blocks,
                      "tokens": tokens, "tokens_per_sec": tokens / wall, "wall_s": wall,
                      "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
                      "decode_tokens_per_sec": engine.slo_summary().get("decode_tokens_per_sec"),
                      "paged_kernel_launches": launches}
    (base, base_reqs), (tight, tight_reqs) = runs["sampled"], runs["sampled_tight"]
    check(tight.stats().preemptions >= 1, "the tight pool preempted nothing")
    streams = [[int(t) for t in base.output_ids(r)] for r in base_reqs]
    tight_streams = [[int(t) for t in tight.output_ids(r)] for r in tight_reqs]
    for i, kw in enumerate(sampling):
        if kw:
            check(streams[i] == tight_streams[i], f"request {i}: the sampled stream changed "
                  f"under preemption ({streams[i]} vs {tight_streams[i]})")
    sampled_idx = {i for i, kw in enumerate(sampling) if kw}
    compared, near_ties = _greedy_agreement(model, base, trace, base_reqs, skip=sampled_idx)
    s_compared, s_near_ties = _sampled_agreement(model, base, trace, base_reqs, sampling)
    rows["sampled"].update(greedy_tokens_compared_with_plain=compared, near_ties=near_ties,
                           sampled_tokens_compared_with_plain=s_compared,
                           sampled_near_ties=s_near_ties,
                           sampled_streams_equal_under_preemption=True)

    int8_model = _kv_twin(model, "int8")
    fp_engine = serve_engine(model)
    int8_engine = serve_engine(model, kv_cache_dtype="int8")
    reqs, wall, launches = _counted_serve(int8_engine, trace)
    compared, near_ties = _greedy_agreement(int8_model, int8_engine, trace, reqs)
    same_bytes = serve_engine(model, kv_cache_dtype="int8",
                              kv_pool_bytes=fp_engine.blocks.pool_bytes)
    cfg = model.config
    heads, head_dim = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    tokens = sum(len(int8_engine.output_ids(r)) for r in reqs)
    k3 = kernels.get("int8", {})
    rows["int8"] = {
        "phase": "serve_int8", "requests": len(reqs), "tokens": tokens,
        "tokens_per_sec": tokens / wall, "wall_s": wall,
        "decode_steps": int8_engine.stats().decode_steps,
        "decode_tokens_per_sec": int8_engine.slo_summary().get("decode_tokens_per_sec"),
        "preemptions": int8_engine.stats().preemptions, "paged_kernel_launches": launches,
        "tokens_compared_with_plain_int8": compared, "near_ties": near_ties,
        "pool_bytes_per_token": {"fp32": fp_engine.blocks.token_bytes,
                                 "int8": int8_engine.blocks.token_bytes},
        "bytes_per_token_per_head": {"fp32": 2 * 4 * head_dim, "int8": 2 * (head_dim + 4)},
        "equal_bytes": {"pool_bytes": fp_engine.blocks.pool_bytes,
                        "fp32_blocks": fp_engine.blocks.num_blocks,
                        "int8_blocks": same_bytes.blocks.num_blocks,
                        "fp32_full_context_requests": (fp_engine.blocks.num_blocks - 1)
                        // (SERVE_MAX_LEN // 16),
                        "int8_full_context_requests": (same_bytes.blocks.num_blocks - 1)
                        // (SERVE_MAX_LEN // 16),
                        "ratio": (same_bytes.blocks.num_blocks - 1)
                        / (fp_engine.blocks.num_blocks - 1)},
        "k3_int8_kernel_ms": k3.get("kernel_ms"), "k3_int8_bound_ms": k3.get("bound_ms"),
        "k3_int8_case": "int8"}
    check(same_bytes.blocks.num_blocks > 2 * fp_engine.blocks.num_blocks,
          "int8 pools did not hold more than twice the blocks on equal bytes")
    for r in rows.values():
        emit(r)
    del fp_engine, same_bytes
    return rows


def profile_phase(model, trace, serve_wall_s: float) -> dict:
    """The serve trace once more, on a fresh engine under
    ``torch.profiler`` (device activity only): device time by kernel, the
    paged kernel's share, and the device's idle share of the counted
    serve run's wall time (the same work, unprofiled). Runs after the
    counted serve run; its launches are not the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine = serve_engine(model)
    for prompt, max_new in trace:
        engine.submit(prompt, max_new)
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = _device_seconds_by_kernel(prof)
    busy = sum(by_kernel.values())
    paged = sum(v for k, v in by_kernel.items() if any(n in k for n in PAGED_KERNEL_NAMES))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    row = {"phase": "profile", "profiled_wall_s": wall,
           "serve_wall_s": serve_wall_s,
           "device_busy_s": busy if busy else "not measured",
           "idle_share": 1.0 - busy / serve_wall_s if busy else "not measured",
           "paged_kernel_s": paged, "paged_kernel_share_of_busy":
           paged / busy if busy else "not measured",
           "decode_steps": engine.decode_steps,
           "top_kernels_s": [[k[:80], v] for k, v in top]}
    emit(row)
    return row

# -- phase 4b: the serve engine's features -------------------------------------

# (a) the JAX prefix bench's templated trace at its accelerator scale
# (benchmarks/serve_bench.py): a 320-token template plus 8-32 tokens of
# tail, 8-16 new tokens (24-32 every 8th), 16 slots, chunk 32, width 512
PREFIX_REQUESTS, PREFIX_LEN, PREFIX_TAILS = 48, 320, (8, 32)
PREFIX_NEW = ((8, 16), (24, 32))
PREFIX_ENGINE = dict(num_slots=16, block_size=16, prefill_chunk=32,
                     max_model_len=512, num_blocks=1 + 8 + 3 * (512 // 16))
# (c) speculation in the engine: k 4, the first 4 layers as the draft
SPEC_K, SPEC_DRAFT_LAYERS = 4, 4
# (d) the JAX swap bench's thrash trace at its accelerator scale: 4
# templates of 192 tokens round-robin, tails 8-24, 8-16 new tokens and 192
# every 4th, 8 slots, chunk 32, width 512, 96 blocks
THRASH = dict(n_requests=32, n_templates=4, template_len=192, tail_lo=8,
              tail_hi=24, short_new=(8, 16), long_new=192, long_every=4)
THRASH_ENGINE = dict(num_slots=8, block_size=16, prefill_chunk=32,
                     max_model_len=512, num_blocks=1 + 3 * (512 // 16))
# (e) the iterations the overlap runs profile for the idle share
OVERLAP_PROFILED = (8, 40)
# (f) the deadline-ordered admission: deadlines (s) in submission order
POLICY_DEADLINES = (40.0, 10.0, 30.0, 20.0)
# (a') copy-on-write on the card: nested templates, a 356-token one (22 full
# blocks, ending on the chunk grid at 352) and its first 340 tokens (21 full
# blocks, off the grid), alternating over 16 requests behind the longer one's
# prime: a request on the shorter one resumes prefill at 320 and rewrites
# block 20, which the requests on the longer one hold, so admission copies it
COW_REQUESTS, COW_LEN, COW_EXT = 16, 340, 356


def _split_at_near_tie(model, prompt, a: list, b: list, kw: dict,
                       tie: float = NEAR_TIE) -> bool:
    """Two runs' tokens for one request first differ at a step where the
    plain forward's top-2 gap (of the logits, or for a sampled request of
    the warped logits plus that step's noise) is below ``tie``
    (``NEAR_TIE``; a bf16 run's tie bound from ``_plain_agreement``): the
    runs' sums in other orders may split there, nowhere else."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen

    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    seq = torch.as_tensor(list(prompt) + a[:j], device=DEVICE)[None]
    with torch.inference_mode():
        logits = model(seq)[0, -1:].float()
    if kw:
        one = lambda v: torch.full((1,), v, device=DEVICE)   # noqa: E731
        logits = gen.warp_logits_per_slot(logits, one(kw["temperature"]),
                                          one(kw.get("top_k", 0)).long(),
                                          one(kw.get("top_p", 0.0)))
        logits = logits + gen._slot_gumbel(one(kw["seed"]).long(), one(j).long(),
                                           logits.shape[-1])
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1]) < tie


def _same_tokens(model, trace, a: list, b: list, what: str, sampling=None,
                 tie: float = NEAR_TIE) -> dict:
    """Each request's tokens of run ``a`` against run ``b``: the same, or
    split at a near-tie of the plain path (``_split_at_near_tie`` under
    ``tie``); anything else fails. ``{"identical": n, "near_tie_splits":
    m}``."""
    sampling = sampling or [{}] * len(trace)
    same = ties = 0
    for i, ((prompt, _), x, y, kw) in enumerate(zip(trace, a, b, sampling)):
        if x == y:
            same += 1
            continue
        check(_split_at_near_tie(model, prompt, x, y, kw, tie),
              f"{what}: request {i}'s tokens differ before any near-tie ({x} vs {y})")
        ties += 1
    return {"identical": same, "near_tie_splits": ties}


def _engine_run(engine, trace, sampling=None, prime=None) -> tuple:
    """Serve ``trace`` on ``engine`` (after ``prime``, a prompt served
    alone first): K3's counts set to 0 just before, read just after.
    ``(outputs, wall seconds, launches)``; a plain-decode engine must
    launch K3 once a layer a decode step, a speculative one never."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    engine.warmup()
    if prime is not None:
        engine.submit(prime, 1)
        engine.run()
    sampling = sampling or [{}] * len(trace)
    reqs = [engine.submit(p, m, **kw) for (p, m), kw in zip(trace, sampling)]
    steps0, launches0 = engine.decode_steps, engine.paged_kernel_launches
    engine.paged_launches_by_width.clear()
    paged_decode_attention.launches = 0
    _sync()
    t0 = time.perf_counter()
    engine.run()
    _sync()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    layers = engine.model.config.num_layers
    check(all(r.rid in engine.finished for r in reqs), "not every request finished")
    check(launches == engine.paged_kernel_launches - launches0,
          f"K3 launches {launches} != the engine's count")
    if engine.speculative or engine.kernel == "xla":
        check(launches == 0, f"a speculative or gather-route engine launched K3 "
              f"{launches} times")
    elif engine.kernel == "pallas":
        check(steps > 0 and launches == steps * layers,
              f"K3 launches {launches} != decode steps {steps} x {layers}")
    return [[int(t) for t in engine.output_ids(r)] for r in reqs], wall, launches


def _idle_window(engine, trace, sampling) -> dict:
    """``trace`` on a fresh ``engine`` (its launches are not a counted
    run's), iterations ``OVERLAP_PROFILED`` under ``torch.profiler``
    (device activity): their wall, the device's busy time and idle share
    in them; the rest of the trace is not served."""
    from torch.profiler import ProfilerActivity, profile

    engine.warmup()
    for (p, m), kw in zip(trace, sampling):
        engine.submit(p, m, **kw)
    lo, hi = OVERLAP_PROFILED
    for _ in range(lo):
        engine.step()
    check(engine.has_work(), f"the run ended before iteration {lo}")
    _sync()
    with profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(hi - lo):
            engine.step()
        _sync()
        wall = time.perf_counter() - t0
    # the engine is dropped mid-trace: only the window is measured
    busy = _device_busy_s(prof)
    return {"window_iterations": [lo, hi], "window_wall_s": wall,
            "device_busy_s": busy if busy else "not measured",
            "idle_share": 1.0 - busy / wall if busy else "not measured"}


class _SyncFreeDispatch:
    """Within the block, ``engine``'s decode dispatches (or the methods
    ``names`` of any object) run under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that makes the
    host wait on the card (a ``.cpu()``, an ``.item()``, a pageable copy)
    raises. ``dispatches`` counts the calls held that returned something."""

    def __init__(self, engine, names=("_dispatch_decode", "_dispatch_spec")):
        self.engine, self.names, self.dispatches = engine, names, 0

    def __enter__(self):
        import torch

        eng = self

        def guarded(fn):
            def run(*args, **kwargs):
                if DEVICE == "cuda":
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    out = fn(*args, **kwargs)
                finally:
                    if DEVICE == "cuda":
                        torch.cuda.set_sync_debug_mode("default")
                eng.dispatches += out is not None
                return out
            return run

        for name in self.names:
            setattr(self.engine, name, guarded(getattr(self.engine, name)))
        return self

    def __exit__(self, *exc):
        for name in self.names:
            delattr(self.engine, name)
        return False


def _engine_row(engine, run: str, outs, wall: float, launches: int, **extra) -> dict:
    st, slo = engine.stats(), engine.slo_summary()
    tokens = sum(len(o) for o in outs)
    return {"phase": "serve_engine", "run": run, "requests": len(outs), "tokens": tokens,
            "tokens_per_sec": tokens / wall, "wall_s": wall,
            "ttft_p50_s": slo.get("ttft_p50_s"), "ttft_p99_s": slo.get("ttft_p99_s"),
            "decode_steps": st.decode_steps, "decode_tokens_per_sec":
            slo.get("decode_tokens_per_sec"), "preemptions": st.preemptions,
            "gather_buckets": engine.gather_buckets,
            "paged_kernel_launches": launches,
            "k3_launches_by_width": {str(w): n for w, n in
                                     sorted(engine.paged_launches_by_width.items())},
            **extra}


def serve_engine_phase(model, trace, tel: Path | None = None) -> dict:
    """The engine's single-device features on GPT-2 124M (fp32, random
    weights from seed 0), each run's K3 counts set to 0 just before it and
    read just after, telemetry on: (a) the prefix cache on against off on
    the templated trace, both primed with the template; (b) the width
    ladder auto against full on the serve trace (the default engine: the
    prefix cache, the ladder and overlap on); (c) speculation in the
    engine (k 4, 4 self-draft layers) against (b)'s run; (d) swap always
    against recompute on the thrash trace; (e) overlap on against off,
    every other request sampled, no decode dispatched ahead making the host
    wait on the card (``_SyncFreeDispatch``), the host's wait on decode
    results per step, and on a second run each the device's idle share
    over ``OVERLAP_PROFILED``; (f) every event of (a)-(e) valid under the
    port's schema, every ``request_timeline`` summing to its e2e
    (``check_decomposition``), and ``policy='slo'`` admitting in deadline
    order. Every pair holds its tokens equal (``_same_tokens``; sampled
    streams too). The events go to ``tel`` when given (and stay there),
    else to a directory removed after the checks."""
    import shutil

    import numpy as np

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
        validate_events_file,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        check_decomposition,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        ServeEngine,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import (
        make_thrash_trace,
        make_trace,
    )

    vocab = model.config.vocab_size - 1
    layers = model.config.num_layers
    keep = tel is not None
    tel = Path(tel) if keep else Path(tempfile.mkdtemp())
    obs.reset(out_dir=str(tel), enabled=True)
    rows, seconds = {}, {}

    def engine(**kw):
        return ServeEngine(model, device=DEVICE, **kw)

    try:
        # (a) prefix cache
        t0 = time.perf_counter()
        rng = np.random.RandomState(3)
        template = rng.randint(1, vocab, (PREFIX_LEN,)).astype(np.int32)
        ptrace = make_trace(rng, PREFIX_REQUESTS, vocab, *PREFIX_TAILS, *PREFIX_NEW,
                            long_every=8, shared_prefix=template)
        runs = {}
        for name, on in (("prefix_on", "on"), ("prefix_off", "off")):
            eng = engine(prefix_cache=on, **PREFIX_ENGINE)
            outs, wall, launches = _engine_run(eng, ptrace, prime=template)
            st = eng.stats()
            runs[name] = outs
            rows[name] = _engine_row(
                eng, name, outs, wall, launches, cache_hit_rate=st.cache_hit_rate,
                blocks_saved_peak=st.blocks_saved_peak, cow_copies=st.cow_copies,
                blocks_shared_peak=st.blocks_shared_peak,
                prefix_cached_tokens=st.prefix_cached_tokens,
                peak_resident_requests=st.peak_resident_requests)
        check(rows["prefix_on"]["cache_hit_rate"] > 0.5, "the prefix cache missed the template")
        rows["prefix_on"]["same_tokens_as_off"] = _same_tokens(
            model, ptrace, runs["prefix_on"], runs["prefix_off"], "(a) prefix cache on/off")
        seconds["a_prefix"] = time.perf_counter() - t0

        # (a') copy-on-write: a template that ends off the chunk grid
        t0 = time.perf_counter()
        rng = np.random.RandomState(5)
        cow_template = rng.randint(1, vocab, (COW_EXT,)).astype(np.int32)
        ctrace = [(np.concatenate([cow_template[:COW_EXT if i % 2 == 0 else COW_LEN], p]), m)
                  for i, (p, m) in enumerate(make_trace(rng, COW_REQUESTS, vocab, *PREFIX_TAILS,
                                                        *PREFIX_NEW, long_every=8))]
        cow = {}
        for name, on in (("cow_on", "on"), ("cow_off", "off")):
            eng = engine(prefix_cache=on, **PREFIX_ENGINE)
            outs, wall, launches = _engine_run(eng, ctrace, prime=cow_template)
            st = eng.stats()
            cow[name] = outs
            rows[name] = _engine_row(
                eng, name, outs, wall, launches, cache_hit_rate=st.cache_hit_rate,
                cow_copies=st.cow_copies, template_tokens=[COW_LEN, COW_EXT])
        check(rows["cow_on"]["cow_copies"] > 0, "the off-grid template copied no block")
        rows["cow_on"]["same_tokens_as_off"] = _same_tokens(
            model, ctrace, cow["cow_on"], cow["cow_off"], "(a') copy-on-write on/off")
        seconds["a_cow"] = time.perf_counter() - t0

        # (b) the width ladder: the default engine, auto against full
        t0 = time.perf_counter()
        ladder = {}
        for name, buckets in (("ladder_auto", "auto"), ("ladder_full", "full")):
            eng = serve_engine(model, prefix_cache="on", overlap="on", gather_buckets=buckets)
            outs, wall, launches = _engine_run(eng, trace)
            st = eng.stats()
            ladder[name] = outs
            rows[name] = _engine_row(
                eng, name, outs, wall, launches, bucket_switches=st.bucket_switches,
                gather_read_waste_peak=st.gather_waste_peak,
                gather_read_waste_mean=st.gather_waste_mean,
                overlap_flushes=st.overlap_flushes)
        check(rows["ladder_auto"]["bucket_switches"] >= 1, "the ladder never switched")
        check(set(rows["ladder_auto"]["k3_launches_by_width"])
              == {str(w) for w in rows["ladder_auto"]["gather_buckets"]},
              "the ladder did not launch K3 at each of its widths")
        rows["ladder_auto"]["same_tokens_as_full"] = _same_tokens(
            model, trace, ladder["ladder_auto"], ladder["ladder_full"], "(b) ladder auto/full")
        seconds["b_ladder"] = time.perf_counter() - t0

        # (b') the gather route (the JAX engine's default) on the same trace
        t0 = time.perf_counter()
        xla_kw = dict(prefix_cache="on", overlap="on", gather_buckets="auto", kernel="xla")
        eng = serve_engine(model, **xla_kw)
        outs, wall, launches = _engine_run(eng, trace)
        rows["xla_route"] = _engine_row(
            eng, "xla_route", outs, wall, launches,
            same_tokens_as_k3=_same_tokens(model, trace, outs, ladder["ladder_auto"],
                                           "(b') xla/K3 route"),
            **_idle_window(serve_engine(model, **xla_kw), trace, [{}] * len(trace)))
        seconds["b_xla"] = time.perf_counter() - t0

        # (c) speculation in the engine against (b)'s default run
        t0 = time.perf_counter()
        eng = serve_engine(model, prefix_cache="on", overlap="on", gather_buckets="auto",
                           speculate_k=SPEC_K, draft=SPEC_DRAFT_LAYERS)
        outs, wall, launches = _engine_run(eng, trace)
        st = eng.stats()
        rows["speculative"] = _engine_row(
            eng, "speculative", outs, wall, launches, speculate_k=SPEC_K,
            draft_layers=SPEC_DRAFT_LAYERS, acceptance_rate=st.acceptance_rate,
            draft_proposed=st.draft_proposed, draft_accepted=st.draft_accepted,
            spec_windows=st.spec_windows,
            tokens_per_target_pass=(st.decode_tokens / st.spec_windows
                                    if st.spec_windows else None),
            verify_read_waste_mean=st.verify_waste_mean,
            same_tokens_as_plain=_same_tokens(model, trace, outs, ladder["ladder_auto"],
                                              "(c) speculative/plain"))
        seconds["c_speculative"] = time.perf_counter() - t0

        # (d) swap against recompute on the thrash trace
        t0 = time.perf_counter()
        thrash, _ = make_thrash_trace(np.random.RandomState(17), vocab=vocab, **THRASH)
        swap_runs = {}
        for name, swap in (("swap_always", "always"), ("recompute", "off")):
            eng = engine(swap=swap, **THRASH_ENGINE)
            outs, wall, launches = _engine_run(eng, thrash)
            st = eng.stats()
            swap_runs[name] = outs
            rows[name] = _engine_row(
                eng, name, outs, wall, launches, swap_outs=st.swap_outs,
                swap_ins=st.swap_ins, swap_bytes=st.swap_bytes, restore_s=st.restore_s,
                host_tier_hits=st.host_tier_hits, host_tier_hit_rate=st.host_tier_hit_rate,
                recompute_tokens_avoided=st.recompute_tokens_avoided,
                overlap_flushes=st.overlap_flushes)
        check(rows["recompute"]["preemptions"] >= 1, "the thrash trace preempted nothing")
        check(rows["swap_always"]["swap_outs"] >= 1
              and rows["swap_always"]["swap_ins"] == rows["swap_always"]["swap_outs"],
              "swap=always swapped nothing out, or not everything back in")
        rows["swap_always"]["same_tokens_as_recompute"] = _same_tokens(
            model, thrash, swap_runs["swap_always"], swap_runs["recompute"],
            "(d) swap/recompute")
        seconds["d_swap"] = time.perf_counter() - t0

        # (e) overlap on against off, every other request sampled
        t0 = time.perf_counter()
        sampling = [dict(SERVE_SAMPLING, seed=i) if i % 2 else {} for i in range(len(trace))]
        over = {}
        for name, ov in (("overlap_on", "on"), ("overlap_off", "off")):
            eng = serve_engine(model, prefix_cache="on", overlap=ov, gather_buckets="auto")
            with _SyncFreeDispatch(eng) as guard:
                outs, wall, launches = _engine_run(eng, trace, sampling)
            st = eng.stats()
            over[name] = outs
            check(ov == "off" or guard.dispatches > 0, "no decode was dispatched ahead")
            rows[name] = _engine_row(
                eng, name, outs, wall, launches, overlap_flushes=st.overlap_flushes,
                sampled_requests=sum(1 for kw in sampling if kw),
                sync_free_dispatches=guard.dispatches,
                host_wait_s=eng.fetch_wait_s, host_waits=eng.fetches,
                host_wait_per_step_s=eng.fetch_wait_s / max(1, eng.fetches),
                **_idle_window(serve_engine(model, prefix_cache="on", overlap=ov,
                                            gather_buckets="auto"), trace, sampling))
        rows["overlap_on"]["same_tokens_as_off"] = _same_tokens(
            model, trace, over["overlap_on"], over["overlap_off"], "(e) overlap on/off",
            sampling)
        seconds["e_overlap"] = time.perf_counter() - t0

        # (f) deadline-ordered admission under policy='slo'
        t0 = time.perf_counter()
        eng = engine(num_slots=1, block_size=16, prefill_chunk=16, max_model_len=128,
                     num_blocks=9, policy="slo", prefix_cache="off")
        prompts = [np.random.RandomState(30 + i).randint(1, vocab, (8,)) for i in
                   range(len(POLICY_DEADLINES))]
        reqs = [eng.submit(p, 2, deadline_s=d) for p, d in zip(prompts, POLICY_DEADLINES)]
        eng.run()
        order = [r.deadline_s for r in sorted(reqs, key=lambda r: r.first_token_t)]
        check(order == sorted(POLICY_DEADLINES), f"policy=slo admitted in order {order}")
        seconds["f_policy"] = time.perf_counter() - t0
    finally:
        obs.reset()
    n_events, errors = validate_events_file(str(tel / "events.jsonl"))
    check(not errors, f"serve_engine events fail the schema: {errors[:3]}")
    timelines = [e for e in map(json.loads, (tel / "events.jsonl").read_text().splitlines())
                 if e.get("type") == "serve" and e.get("event") == "request_timeline"]
    bad = [err for e in timelines for err in check_decomposition(e)]
    check(timelines and not bad, f"request timelines do not sum to e2e: {bad[:3]}")
    if not keep:
        shutil.rmtree(tel, ignore_errors=True)
    rows["telemetry"] = {"phase": "serve_engine", "run": "telemetry", "events": n_events,
                         "request_timelines": len(timelines),
                         "policy_slo_admission_order": order, "seconds": seconds}
    for r in rows.values():
        emit(r)
    return rows


# -- the serve_router phase ------------------------------------------------------
#
# The JAX bench's accelerator-scale settings (benchmarks/serve_bench.py):
# (a) placement: 8 slots, block 16, chunk 32, width 256, ladder [128, 256];
# the 48-request mixed trace (prompts 16-32, 32-48 new, 64-96 every 4th,
# seed 7) and the templated one (4 families x 8 behind a 96-token prefix,
# tails 2-5, 3-5 new, seed 8, primed); the bench's pool formula
ROUTER_ENGINE = dict(num_slots=8, block_size=16, prefill_chunk=32, max_model_len=256,
                     gather_buckets=[128, 256])
ROUTER_TRACE = dict(n_requests=48, prompt_lo=16, prompt_hi=32, short_new=(32, 48),
                    long_new=(64, 96), long_every=4)
ROUTER_FAMILIES = (4, 8, 96)    # families, requests per family, prefix tokens
ROUTER_BLOCKS = (1 + 8 * ((32 + 32 + 96 + 16) // 16 + 1)
                 + 8 * ((96 + 32 + 16) // 16 + 1))          # 177
ROUTER_PROFILED = (8, 40)       # the fleet iterations profiled for the idle share
# (c) roles and (d) the open loop: 4 slots, block 16, chunk 32, width 256
FLEET4_ENGINE = dict(num_slots=4, block_size=16, prefill_chunk=32, max_model_len=256,
                     gather_buckets=[128, 256])
DISAGG = dict(n=32, prompt=(32, 128), new=(8, 24), rate=500.0, ttft_s=0.01)
OPEN_LOOP = dict(n=32, prompt=(8, 24), new=(8, 24), rates=(40.0, 100000.0),
                 wall_rates=(8.0, 32.0, 128.0))
FLEET_TICK_S, FLEET_SEED = 0.001, 11


def _fleet_snapshot(router) -> list:
    """Each replica's (K3 launches, decode steps) now, and its by-width
    tally cleared: a run's per-replica counts are differences from it."""
    for eng in router.engines:
        eng.paged_launches_by_width.clear()
    return [(eng.paged_kernel_launches, eng.decode_steps) for eng in router.engines]


def _fleet_counts(router, snap, launches: int) -> dict:
    """One run's K3 launches per replica and by width, from each engine's
    own tally (the global counter sums interleaved replicas); they must
    sum to the global count and equal each replica's decode steps x
    layers."""
    layers = router.engines[0].model.config.num_layers
    per = {}
    for i, (eng, (l0, s0)) in enumerate(zip(router.engines, snap)):
        n, steps = eng.paged_kernel_launches - l0, eng.decode_steps - s0
        check(n == steps * layers, f"replica {i}: K3 launches {n} != decode steps "
              f"{steps} x {layers}")
        per[str(i)] = {"launches": n, "by_width": {
            str(w): c for w, c in sorted(eng.paged_launches_by_width.items())}}
    check(sum(r["launches"] for r in per.values()) == launches,
          f"the replicas' K3 tallies do not sum to the {launches} launches counted")
    return per


class _OwnEvents:
    """Within the block, every event ``engine`` waits on must be one its own
    fetches recorded: one stream carries every replica's work, and no
    replica may wait on another's dispatch in flight. ``waits`` counts the
    events checked."""

    def __init__(self, engine):
        self.engine, self.own, self.waits = engine, {}, 0

    def __enter__(self):
        eng, real_fetch, real_wait = self, self.engine._d2h_async, self.engine._wait

        def fetch(tensors):
            hosts, event = real_fetch(tensors)
            if event is not None:
                eng.own[id(event)] = event          # held: ids are not reused
            return hosts, event

        def wait(event):
            if event is not None:
                check(eng.own.get(id(event)) is event,
                      f"replica {eng.engine.replica} waited on an event it did not record")
                eng.waits += 1
            return real_wait(event)

        self.engine._d2h_async, self.engine._wait = fetch, wait
        return self

    def __exit__(self, *exc):
        del self.engine._d2h_async, self.engine._wait
        return False


def _guarded(router):
    """The fleet's dispatches ahead and its placement path (submit, the
    policy's choice, the least-loaded scan) under the sync debug mode, and
    each replica waiting only on its own events."""
    import contextlib

    stack = contextlib.ExitStack()
    guards = [stack.enter_context(_SyncFreeDispatch(eng)) for eng in router.engines]
    guards.append(stack.enter_context(_SyncFreeDispatch(
        router, ("submit", "_place", "_least_loaded"))))
    guards += [stack.enter_context(_OwnEvents(eng)) for eng in router.engines]
    return stack, guards


def _fleet_run(router, trace, prime=(), drain_at=None, cross_check=False) -> dict:
    """Serve ``trace`` through ``router`` (after ``prime``, prompts served
    alone first), K3's counts set to 0 just before and read just after;
    fleet iterations ``ROUTER_PROFILED`` under ``torch.profiler`` for the
    device's idle share; with ``drain_at``, replica 1 drains after that
    many fleet iterations; ``cross_check`` holds the window's busy time
    against the profiler's by-kernel aggregation."""
    from torch.profiler import ProfilerActivity, profile

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )

    router.warmup()
    if prime:
        for p in prime:
            router.submit(p, 1)
        router.run()
    stack, guards = _guarded(router)
    with stack:
        reqs = [router.submit(p, m) for p, m in trace]
        snap = _fleet_snapshot(router)
        paged_decode_attention.launches = 0
        _sync()
        t0 = time.perf_counter()
        lo, hi = ROUTER_PROFILED
        it, window = 0, None
        while router.has_work():
            if it == lo:
                _sync()
                prof = profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                                           else ProfilerActivity.CPU])
                prof.__enter__()
                tw = time.perf_counter()
            router.step()
            it += 1
            if it == hi:
                _sync()
                window = (time.perf_counter() - tw, prof)
                prof.__exit__(None, None, None)
            if drain_at is not None and it == drain_at:
                router.drain(1)
        if lo <= it < hi:
            _sync()
            window = (time.perf_counter() - tw, prof)
            prof.__exit__(None, None, None)
        router.run()
        _sync()
        wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    check(all(r.rid in router.finished for r in reqs), "not every request finished")
    busy = _device_busy_s(window[1]) if window else 0.0
    if cross_check and busy:
        # the direct sum against the profiler's own aggregation, once
        fast, slow = _device_seconds_by_kernel(window[1]), _key_averaged_seconds(window[1])
        check(fast.keys() == slow.keys() and all(
            abs(fast[k] - slow[k]) <= 1e-6 * slow[k] + 1e-9 for k in slow),
              f"device seconds by kernel {fast} off the profiler's {slow}")
    slo = router.slo_summary()
    outs = [[int(t) for t in router.output_ids(r)] for r in reqs]
    tokens = sum(len(o) for o in outs)
    return {"outs": outs, "reqs": reqs, "row": {
        "requests": len(reqs), "tokens": tokens, "tokens_per_sec": tokens / wall,
        "wall_s": wall, "fleet_iterations": it,
        "ttft_p50_s": slo.get("ttft_p50_s"), "ttft_p99_s": slo.get("ttft_p99_s"),
        "cache_hit_rate": slo.get("cache_hit_rate"),
        "replica_load_imbalance": slo.get("replica_load_imbalance", 1.0),
        "peak_resident_requests": sum(e.peak_resident for e in router.engines),
        "window_iterations": [lo, min(it, hi)],
        "idle_share": (1.0 - busy / window[0]) if busy else "not measured",
        "paged_kernel_launches": launches,
        "k3_launches_by_replica": _fleet_counts(router, snap, launches),
        "sync_free_calls": sum(g.dispatches for g in guards if hasattr(g, "dispatches")),
        "own_event_waits": sum(g.waits for g in guards if hasattr(g, "waits"))}}


def _open_loop_run(router, schedule, clock: str, slo, rate: float) -> dict:
    """One ``OpenLoopDriver`` run, K3's counts set to 0 just before."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.loadgen import (
        OpenLoopDriver,
    )

    drv = OpenLoopDriver(router, schedule, clock=clock, tick_s=FLEET_TICK_S, slo=slo,
                         process="poisson", rate=rate)
    router.warmup()
    snap = _fleet_snapshot(router)
    paged_decode_attention.launches = 0
    stack, guards = _guarded(router)
    with stack:
        t0 = time.perf_counter()
        finished = drv.run()
        _sync()
        wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    check(len(finished) == len(schedule), "not every request finished")
    outs = [[int(t) for t in router.output_ids(finished[rid])] for rid in sorted(finished)]
    return {"outs": outs, "summary": drv.summary(), "slo": router.slo_summary(),
            "wall_s": wall, "paged_kernel_launches": launches,
            "k3_launches_by_replica": _fleet_counts(router, snap, launches),
            "sync_free_calls": sum(g.dispatches for g in guards if hasattr(g, "dispatches")),
            "own_event_waits": sum(g.waits for g in guards if hasattr(g, "waits"))}


def _stitched(tel: Path, what: str) -> dict:
    """The traced events of one run stitched: every trace complete, and
    every complete trace passing the port's ``check_trace``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
        validate_events_file,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.trace import (
        check_trace,
        collect_traces,
        fleet_summary,
    )

    n_events, errors = validate_events_file(str(tel / "events.jsonl"))
    check(not errors, f"{what}: events fail the schema: {errors[:3]}")
    events = [json.loads(x) for x in (tel / "events.jsonl").read_text().splitlines()]
    traces = collect_traces(events)
    bad = [(t["trace_id"], t["incomplete"]) for t in traces if not t["complete"]]
    check(traces and not bad, f"{what}: incomplete traces {bad[:3]}")
    errs = [e for t in traces for e in check_trace(t)]
    check(not errs, f"{what}: stitched traces fail check_trace: {errs[:3]}")
    fleet = fleet_summary(traces)
    return {"events": n_events, "traces": len(traces),
            "complete_traces": fleet["complete_traces"],
            "transport_hops": fleet.get("transport_hops", 0),
            "transport_hop_s_p50": fleet.get("transport_hop_s_p50"),
            "transport_hop_s_p99": fleet.get("transport_hop_s_p99"),
            "hops_by_trace": sorted({t["hops"] for t in traces})}


def serve_router_phase(model, card: str, tel: Path | None = None) -> dict:
    """The multi-replica fleet on GPT-2 124M (fp32, the serve phase's
    weights), every replica on the one card with K3 and overlap on (the
    engine's defaults), the replicas sharing the model's tensors, each
    run's K3 counts set to 0 just before it and read just after (per
    replica from each engine's own tally), the fleet's dispatches ahead
    and its placement path under the sync debug mode: (a) placement, one
    engine against two replicas under ``round_robin``, ``least_loaded``
    and ``affinity`` on the mixed trace, and ``round_robin`` against
    ``affinity`` on the primed templated trace (tokens/s, TTFT, hit rate,
    imbalance, peak resident, idle share over fleet iterations
    ``ROUTER_PROFILED``); every fleet's tokens equal the one engine's up
    to a near-tie, affinity's hit rate at least round-robin's; (b) the
    affinity fleet drained of replica 1 in the middle of the mixed trace:
    residents migrated live, their bytes, restore and hop seconds, tokens
    as in (a), every trace stitched complete; (c) ``prefill:1,decode:1``
    against two mixed replicas on a Poisson schedule (virtual clock, TTFT
    SLO): tokens equal, no decode step on the prefill replica, every
    request migrated once, every stitched trace complete and passing
    ``check_trace``; (d) the open loop at two virtual rates, the first
    twice (its summary repeats exactly), then the wall clock at
    ``OPEN_LOOP["wall_rates"]`` (reported, not gated), each wall run's
    events in a directory of its own. The events go to ``tel`` when given
    (and stay there), else to a directory removed at the end."""
    import shutil

    import numpy as np

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import percentile
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.loadgen import (
        SloSpec,
        make_schedule,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.router import Router
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.trace import make_trace

    vocab = model.config.vocab_size - 2
    eos = model.config.eos_token_id
    rows, seconds = {}, {}
    keep = tel is not None
    tel = Path(tel) if keep else Path(tempfile.mkdtemp())

    def fleet(n, placement="round_robin", **kw):
        return Router(model, replicas=n, placement=placement, device=DEVICE,
                      num_blocks=ROUTER_BLOCKS, **{**ROUTER_ENGINE, **kw})

    def sink(name: str) -> Path:
        obs.reset(out_dir=str(tel / name), enabled=True)
        return tel / name

    try:
        # (a) placement
        t0 = time.perf_counter()
        rng = np.random.RandomState(7)
        mixed = make_trace(rng, ROUTER_TRACE["n_requests"], vocab, ROUTER_TRACE["prompt_lo"],
                           ROUTER_TRACE["prompt_hi"], ROUTER_TRACE["short_new"],
                           ROUTER_TRACE["long_new"], ROUTER_TRACE["long_every"])
        families, per_family, prefix_len = ROUTER_FAMILIES
        rng = np.random.RandomState(8)
        prefixes = [rng.randint(1, vocab, (prefix_len,)).astype(np.int32)
                    for _ in range(families)]
        templated = []
        for _ in range(per_family):
            for f in range(families):
                tail = rng.randint(1, vocab, (int(rng.randint(2, 6)),)).astype(np.int32)
                templated.append((np.concatenate([prefixes[f], tail]), int(rng.randint(3, 6))))
        sink("placement")
        runs = {"single": _fleet_run(fleet(1), mixed)}
        for placement in ("round_robin", "least_loaded", "affinity"):
            runs[placement] = _fleet_run(fleet(2, placement), mixed)
        for placement in ("round_robin", "affinity"):
            runs[f"templated_{placement}"] = _fleet_run(
                fleet(2, placement), templated, prime=prefixes,
                cross_check=placement == "round_robin")
        for name, r in runs.items():
            rows[name] = dict(r["row"], phase="serve_router", run=name)
        for placement in ("round_robin", "least_loaded", "affinity"):
            rows[placement]["same_tokens_as_single"] = _same_tokens(
                model, mixed, runs[placement]["outs"], runs["single"]["outs"],
                f"(a) {placement} against one engine")
            check(set(rows[placement]["k3_launches_by_replica"]) == {"0", "1"}
                  and all(v["launches"] > 0 for v in
                          rows[placement]["k3_launches_by_replica"].values()),
                  f"(a) {placement}: a replica launched no K3")
        rows["templated_affinity"]["same_tokens_as_round_robin"] = _same_tokens(
            model, templated, runs["templated_affinity"]["outs"],
            runs["templated_round_robin"]["outs"], "(a) templated affinity/round-robin")
        check(rows["templated_affinity"]["cache_hit_rate"]
              >= rows["templated_round_robin"]["cache_hit_rate"],
              "(a) affinity's hit rate is below round-robin's on the templated trace")
        seconds["a_placement"] = time.perf_counter() - t0

        # (b) a live drain in the middle of the affinity run
        t0 = time.perf_counter()
        drain_tel = sink("drain")
        router = fleet(2, "affinity")
        r = _fleet_run(router, mixed, drain_at=rows["affinity"]["fleet_iterations"] // 2)
        st = router.slo_summary()
        hops = sorted(h for e in router.engines for h in e.transport_hop_s)
        rows["drain"] = dict(
            r["row"], phase="serve_router", run="drain", card=card, telemetry=str(drain_tel),
            drains=router.drains, requeues=router.requeues,
            residents_migrated=router.migrations,
            migration_bytes=st.get("migration_bytes", 0),
            migration_restore_s=st.get("migration_restore_s", 0.0),
            transport_hop_s_p50=percentile(hops, 0.50) if hops else None,
            transport_hop_s_p99=percentile(hops, 0.99) if hops else None,
            same_tokens_as_single=_same_tokens(model, mixed, r["outs"],
                                               runs["single"]["outs"], "(b) drain"))
        check(router.drains == 1 and router.migrations > 0,
              "(b) the drain migrated no resident")
        obs.reset()
        rows["drain"]["stitched"] = _stitched(drain_tel, "(b) drain")
        seconds["b_drain"] = time.perf_counter() - t0

        # (c) prefill/decode roles against two mixed replicas
        t0 = time.perf_counter()
        schedule = make_schedule(DISAGG["n"], vocab, process="poisson", rate=DISAGG["rate"],
                                 seed=FLEET_SEED, prompt_lo=DISAGG["prompt"][0],
                                 prompt_hi=DISAGG["prompt"][1], new_lo=DISAGG["new"][0],
                                 new_hi=DISAGG["new"][1], eos_token_id=eos)
        strace = [(np.asarray(sp["prompt"], np.int32), sp["max_new_tokens"])
                  for _, sp in sorted(schedule, key=lambda row: row[0])]
        slo = SloSpec(ttft_s=DISAGG["ttft_s"])
        blocks4 = 1 + 4 * ((DISAGG["prompt"][1] + 32 + DISAGG["new"][1] + 16) // 16 + 1)
        disagg_tel = sink("roles")
        dis_router = Router(model, roles="prefill:1,decode:1", device=DEVICE,
                            num_blocks=blocks4, **FLEET4_ENGINE)
        dis = _open_loop_run(dis_router, schedule, "virtual", slo, DISAGG["rate"])
        sink("mixed")
        mix = _open_loop_run(Router(model, replicas=2, device=DEVICE, num_blocks=blocks4,
                                    **FLEET4_ENGINE), schedule, "virtual", slo, DISAGG["rate"])
        obs.reset()
        pre, dec = dis_router.engines
        check(pre.decode_steps == 0 and pre.paged_kernel_launches == 0,
              "(c) the prefill replica ran a decode step")
        check(dis_router.migrations == DISAGG["n"]
              and all(req.hop == 1 for req in dis_router.finished.values()),
              "(c) not every request migrated exactly once")
        rows["roles"] = {
            "phase": "serve_router", "run": "roles", "requests": DISAGG["n"],
            "rate": DISAGG["rate"], "clock": "virtual",
            "slo_attainment": dis["summary"].get("slo_attainment"),
            "mixed_slo_attainment": mix["summary"].get("slo_attainment"),
            "ttft_p50_s": dis["summary"].get("ttft_p50_s"),
            "mixed_ttft_p50_s": mix["summary"].get("ttft_p50_s"),
            "tpot_p50_s": dis["summary"].get("tpot_p50_s"),
            "mixed_tpot_p50_s": mix["summary"].get("tpot_p50_s"),
            "migrations": dis_router.migrations,
            "migration_bytes": dis["slo"].get("migration_bytes"),
            "prefill_decode_steps": pre.decode_steps, "wall_s": dis["wall_s"],
            "mixed_wall_s": mix["wall_s"],
            "paged_kernel_launches": dis["paged_kernel_launches"],
            "k3_launches_by_replica": dis["k3_launches_by_replica"],
            "mixed_paged_kernel_launches": mix["paged_kernel_launches"],
            "mixed_k3_launches_by_replica": mix["k3_launches_by_replica"],
            "sync_free_calls": dis["sync_free_calls"] + mix["sync_free_calls"],
            "same_tokens_as_mixed": _same_tokens(model, strace, dis["outs"], mix["outs"],
                                                 "(c) roles/mixed"),
            "stitched": _stitched(disagg_tel, "(c) roles")}
        check(rows["roles"]["stitched"]["traces"] == DISAGG["n"]
              and rows["roles"]["stitched"]["hops_by_trace"] == [1],
              "(c) not every request stitched into one one-hop trace")
        seconds["c_roles"] = time.perf_counter() - t0

        # (d) the open loop: two virtual rates (the first twice), then wall
        t0 = time.perf_counter()

        def oschedule(rate):
            return make_schedule(OPEN_LOOP["n"], vocab, process="poisson", rate=rate,
                                 seed=FLEET_SEED, prompt_lo=OPEN_LOOP["prompt"][0],
                                 prompt_hi=OPEN_LOOP["prompt"][1], new_lo=OPEN_LOOP["new"][0],
                                 new_hi=OPEN_LOOP["new"][1], eos_token_id=eos,
                                 groups=("interactive", "batch"))

        oblocks = 1 + 4 * ((OPEN_LOOP["prompt"][1] + 32 + OPEN_LOOP["new"][1] + 16) // 16 + 1)

        def ofleet():
            return Router(model, replicas=2, device=DEVICE, num_blocks=oblocks,
                          **{**FLEET4_ENGINE, "timeline": "off", "prefix_cache": "off"})

        rate_lo, rate_hi = OPEN_LOOP["rates"]
        slo_lo, slo_hi = SloSpec(ttft_s=0.02, tpot_s=0.01), SloSpec(ttft_s=0.005)
        lo_a = _open_loop_run(ofleet(), oschedule(rate_lo), "virtual", slo_lo, rate_lo)
        lo_b = _open_loop_run(ofleet(), oschedule(rate_lo), "virtual", slo_lo, rate_lo)
        hi = _open_loop_run(ofleet(), oschedule(rate_hi), "virtual", slo_hi, rate_hi)
        check(json.dumps(lo_a["summary"], sort_keys=True)
              == json.dumps(lo_b["summary"], sort_keys=True) and lo_a["outs"] == lo_b["outs"],
              "(d) the virtual replay differs")
        wall_runs = {}
        for rate in OPEN_LOOP["wall_rates"]:
            wall_tel = sink(f"open_loop_wall_{rate:g}")
            w = _open_loop_run(ofleet(), oschedule(rate), "wall",
                               SloSpec(ttft_s=0.5, tpot_s=0.25), rate)
            obs.reset()
            wall_runs[str(rate)] = {k: w["summary"].get(k) for k in (
                "slo_attainment", "slo_met", "goodput_tokens", "miss_phases",
                "dominant_miss_phase", "group_slo_attainment")}
            wall_runs[str(rate)].update(wall_s=w["wall_s"],
                                        paged_kernel_launches=w["paged_kernel_launches"],
                                        telemetry=str(wall_tel))
        rows["open_loop"] = {
            "phase": "serve_router", "run": "open_loop", "requests": OPEN_LOOP["n"],
            "virtual": {str(rate_lo): lo_a["summary"], str(rate_hi): hi["summary"]},
            "virtual_replay_identical": True, "wall": wall_runs,
            "paged_kernel_launches": lo_a["paged_kernel_launches"],
            "k3_launches_by_replica": lo_a["k3_launches_by_replica"],
            "sync_free_calls": lo_a["sync_free_calls"]}
        seconds["d_open_loop"] = time.perf_counter() - t0
    finally:
        obs.reset()
        if not keep:
            shutil.rmtree(tel, ignore_errors=True)
    rows["summary"] = {"phase": "serve_router", "run": "summary", "card": card,
                       "seconds": seconds}
    for r in rows.values():
        emit(r)
    return rows


# -- build -------------------------------------------------------------------

def build_phase() -> dict:
    """Every kernel source at once, one nvcc each, under a compile tracker
    (the nvcc builds it counted and their summed seconds: on a cold
    ``build/``, what a user pays at first use); then the build report of
    the paged, flash and vocab-CE kernels (``build_report``)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.watchdog import (
        CompileTracker,
        _INSTALLED,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    names = _build.SOURCES
    cold = [n for n in names if not _build.library_path(n).exists()]
    tracker = CompileTracker(obs.state(), budget_s=None)
    _INSTALLED.append(tracker)
    t0 = time.perf_counter()
    try:
        _build.build(*names)
    finally:
        _INSTALLED.remove(tracker)
    check(tracker.count == len(cold), f"the tracker counted {tracker.count} builds of "
                                      f"{len(cold)} missing libraries")
    emit({"phase": "build", "libraries": [str(_build.library_path(n).relative_to(ROOT))
                                          for n in names],
          "seconds": round(time.perf_counter() - t0, 3), "cold_libraries": cold,
          "nvcc_builds": tracker.count, "nvcc_cum_s": tracker.cum_secs})
    return build_report()


def _ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) of an ``nvcc -Xptxas -v`` report: its
    registers, static shared memory, stack frame and spill bytes."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(m[1]) if m else 0
    return out


def _sass_counts(sass: str, opcode: str) -> dict:
    """Per function (mangled name) of ``cuobjdump -sass``: how many of
    its instructions (predicated or not) have the opcode ``opcode``."""
    import re

    out, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = re.search(r"Function : (\S+)", line).group(1)
            out[cur] = 0
        elif (cur is not None and opcode in line
              and re.search(rf"\*/\s+(@\S+\s+)?{opcode}\b", line)):
            out[cur] += 1
    return out


# the tensor-core kernels: each must hold HMMA (``mma.sync``), or HGMMA
# (``wgmma``) where named, and spill nothing
TC_KERNELS = (("flash_fwd_tc_kernel", (64, 128, 256)),
              ("flash_bwd_dq_tc_kernel", (64, 128, 256)),
              ("flash_bwd_dkv_tc_kernel", (64, 128, 256)),
              ("vocab_ce_fwd_wgmma_kernel", (None,), "HGMMA"),
              ("vocab_ce_ds_wgmma_kernel", (None,), "HGMMA"),
              ("vocab_ce_dh_wgmma_kernel", (None,), "HGMMA"),
              ("vocab_ce_dw_wgmma_kernel", (None,), "HGMMA"))


def _library_report(lib_name: str, kernels) -> dict:
    """ptxas's report and the SASS ``HMMA`` and ``HGMMA`` counts of each
    entry function of a built library, by mangled name, for the kernels
    named in ``kernels`` (the longest name that a mangled name holds
    wins)."""
    import shutil

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build

    ptxas = _ptxas_report(_build.build_log(lib_name).read_text())
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(lib_name))],
                          capture_output=True, text=True, check=True).stdout
    hmma, hgmma = _sass_counts(sass, "HMMA"), _sass_counts(sass, "HGMMA")
    out = {}
    for mangled, info in ptxas.items():
        kernel = next((k for k in sorted(set(kernels), key=len, reverse=True)
                       if k in mangled), None)
        if kernel is not None:
            out[mangled] = (kernel, dict(info, hmma_instructions=hmma.get(mangled, 0),
                                         hgmma_instructions=hgmma.get(mangled, 0)))
    return out


# template arguments of a paged kernel's mangled name: q's type, the
# pools' (``S1_`` repeats the bf16 of q, ``a`` is int8_t), D, the group
# size the registers hold
_PAGED_SPLIT_ARGS = r"paged_decode_split_kernelI(f|13__nv_bfloat16)(f|a|S\d*_)Li(\d+)ELi(\d+)E"
_PAGED_COMBINE_ARGS = r"paged_decode_combine_kernelI(f|13__nv_bfloat16)Li(\d+)E"


def _paged_instance(mangled: str) -> tuple:
    """(kernel, D, q dtype, pool dtype, group slots) of a paged kernel's
    mangled name; the combine kernel has no pool dtype or group."""
    import re

    qdt = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    m = re.search(_PAGED_SPLIT_ARGS, mangled)
    if m:
        kv = "int8" if m[2] == "a" else "float32" if m[2] == "f" else "bfloat16"
        return PAGED_KERNEL_NAMES[0], int(m[3]), qdt[m[1]], kv, int(m[4])
    m = re.search(_PAGED_COMBINE_ARGS, mangled)
    check(m is not None, f"unknown paged kernel {mangled}")
    return PAGED_KERNEL_NAMES[1], int(m[2]), qdt[m[1]], None, None


def _paged_build_rows() -> dict:
    """One row per paged kernel instance: registers, spills and shared
    memory per block, the split kernel's dynamic size at the serve shape
    (8 slots, 12 kv heads, width 1024, block 16). CUDA cores by design
    (no HMMA is asked of them); none may spill."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import paged_attention as pa

    lib = pa._kernel_lib()
    chunk = pa.split_plan(8, 12, 1024, 16, _sms())[0]
    rows = {}
    for mangled, (kernel, info) in _library_report("paged_attention",
                                                   PAGED_KERNEL_NAMES).items():
        key = _paged_instance(mangled)
        _, D, qdt, kv, group = key
        dynamic = 0 if group is None else lib.paged_decode_split_smem_bytes(
            D, group, chunk, 16, int(qdt == "bfloat16"), int(kv == "int8"))
        rows[key] = {"phase": "kernel_build", "library": "paged_attention", "kernel": kernel,
                     "head_dim": D, "dtype": qdt, "pool_dtype": kv, "group_slots": group,
                     **info, "smem_bytes_per_block": info["static_smem_bytes"] + dynamic}
        check(info["spill_store_bytes"] == 0 and info["spill_load_bytes"] == 0,
              f"{kernel} {key} spills registers: {info}")
    check(len(rows) == 54, f"{len(rows)} paged kernel instances built, not 48 + 6")
    return rows


def build_report() -> dict:
    """Each paged, flash and vocab-CE kernel of the built libraries:
    registers, spills (ptxas), shared memory per block (static plus the
    dynamic size the launch asks for at the main path's shape), and its
    tensor-core instructions in the SASS (``HMMA``). The tensor-core
    kernels must hold HMMA and spill nothing, the paged kernels must not
    spill. Returns the rows by (kernel, D, dtype); a vocab-CE row has D
    None, a paged row is keyed by ``_paged_instance``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

    flib, vlib = fa._kernel_lib(), vc._kernel_lib()
    which = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}
    rows = _paged_build_rows()
    for mangled, (kernel, info) in _library_report(
            "flash_attention", FLASH_KERNEL_NAMES.values()).items():
        D = next(d for d in (256, 128, 64) if f"Li{d}E" in mangled)
        dt = "bfloat16" if ("bfloat16" in mangled or "_tc_" in kernel) else "float32"
        wrapper = next(w for (w, d), k in FLASH_KERNEL_NAMES.items() if k == kernel)
        rows[(kernel, D, dt)] = {"phase": "kernel_build", "library": "flash_attention",
                                 "kernel": kernel, "head_dim": D, "dtype": dt, **info,
                                 "smem_bytes_per_block": flib.flash_attention_smem_bytes(
                                     which[wrapper], D, int(dt == "bfloat16"))}
    for mangled, (kernel, info) in _library_report(
            "vocab_ce", [n for names in VOCAB_KERNEL_NAMES.values() for n in names]).items():
        bf16_only = "_wgmma_" in kernel or kernel in VOCAB_BF16_HELPERS
        dt = ("bfloat16" if ("bfloat16" in mangled or bf16_only)
              else "float32" if "IfE" in mangled else None)
        dynamic = vlib.vocab_ce_wgmma_smem_bytes() if "_wgmma_" in kernel else 0
        rows[(kernel, None, dt)] = {"phase": "kernel_build", "library": "vocab_ce",
                                    "kernel": kernel, "dtype": dt, **info,
                                    "smem_bytes_per_block": info["static_smem_bytes"] + dynamic}
    for row in rows.values():
        emit(row)
    for kernel, dims, *opcode in TC_KERNELS:
        op = opcode[0] if opcode else "HMMA"
        for D in dims:
            r = rows.get((kernel, D, "bfloat16"))
            check(r is not None, f"no ptxas report for {kernel}<{D}>")
            check(r[f"{op.lower()}_instructions"] > 0, f"{kernel}<{D}> has no {op} in its SASS")
            check(r["spill_store_bytes"] == 0 and r["spill_load_bytes"] == 0,
                  f"{kernel}<{D}> spills registers: {r}")
    return rows


def _sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


# -- flash kernels -----------------------------------------------------------

FLASH_CASES = [
    # name, B, H, S, D, dtype, masked, causal, window, pad_row, mask_grad
    ("bert_fp32", 8, 12, 512, 64, "float32", True, False, None, False, False),
    ("bert_bf16", 8, 12, 512, 64, "bfloat16", True, False, None, False, False),
    ("ragged200", 8, 12, 200, 64, "float32", True, False, None, False, False),
    ("causal", 8, 12, 512, 64, "float32", False, True, None, False, False),
    ("causal_window64", 8, 12, 512, 64, "float32", False, True, 64, False, False),
    ("pad_row", 8, 12, 512, 64, "float32", True, False, None, True, False),
    ("dmask", 8, 12, 512, 64, "float32", True, False, None, False, True),
    ("d128_bf16", 4, 8, 512, 128, "bfloat16", True, False, None, False, False),
    # the tensor-core (bf16) kernels on every masking path
    ("ragged200_bf16", 8, 12, 200, 64, "bfloat16", True, False, None, False, False),
    ("causal_bf16", 8, 12, 512, 64, "bfloat16", False, True, None, False, False),
    ("causal_window64_bf16", 8, 12, 512, 64, "bfloat16", False, True, 64, False, False),
    ("pad_row_bf16", 8, 12, 512, 64, "bfloat16", True, False, None, True, False),
    ("dmask_bf16", 8, 12, 512, 64, "bfloat16", True, False, None, False, True),
    # the encoder_tasks phase's shapes: BERT-large QA at 384 and its
    # windowed run at 64 (16 heads), ELECTRA-small's 4 heads at 512
    ("qa384_bf16", 8, 16, 384, 64, "bfloat16", True, False, None, False, False),
    ("qa64_bf16", 8, 16, 64, 64, "bfloat16", True, False, None, False, False),
    ("electra512_bf16", 8, 4, 512, 64, "bfloat16", True, False, None, False, False),
    # the mlm phase's BERT-large-WWM run: 16 heads at 512
    ("mlm_large_bf16", 8, 16, 512, 64, "bfloat16", True, False, None, False, False),
    # the llama phase's training shapes (K/V repeated to the query heads):
    # TinyLlama's 32 heads at S 1024, D 64; Mixtral's at S 512, D 128; and
    # Mistral-7B's window of 4096 on a context of 6144, where the band
    # bites and the tiles below it are skipped
    ("tinyllama_causal_bf16", 4, 32, 1024, 64, "bfloat16", False, True, None, False, False),
    ("mixtral_causal_bf16", 2, 32, 512, 128, "bfloat16", False, True, None, False, False),
    ("mistral_window_bf16", 1, 32, 6144, 128, "bfloat16", False, True, 4096, False, False),
    # the Gemma-2B training shapes at head_dim 256 (its one K/V head
    # repeated to the 8 query heads): the bf16 run's B 2 x S 1024 and the
    # fp32 gate's B 2 x S 512; and a head_dim without an instance (96),
    # run padded to 128
    ("gemma2b_causal_bf16", 2, 8, 1024, 256, "bfloat16", False, True, None, False, False),
    ("gemma2b_gate_fp32", 2, 8, 512, 256, "float32", False, True, None, False, False),
    ("pad96_bf16", 2, 8, 1024, 96, "bfloat16", False, True, None, False, False),
    # the bucket widths the data phase's bucketed run trains at
    ("bucket64_bf16", 8, 12, 64, 64, "bfloat16", True, False, None, False, False),
    ("bucket128_bf16", 8, 12, 128, 64, "bfloat16", True, False, None, False, False),
]
FLASH_LLAMA = ("tinyllama_causal_bf16", "mixtral_causal_bf16", "mistral_window_bf16")
FLASH_GEMMA = ("gemma2b_causal_bf16", "gemma2b_gate_fp32", "pad96_bf16")
FLASH_QA = "qa384_bf16"         # the encoder_tasks phase's headline shape
FLASH_MLM = "mlm_large_bf16"    # the mlm phase's BERT-large shape
FLASH_MAIN = "bert_bf16"        # the shape and dtype the CLI's main path runs
FLASH_COPIES = 2
# the kernel each flash wrapper launches, by dtype (device time is read
# per kernel name from a profile)
FLASH_KERNEL_NAMES = {
    ("flash_fwd", "float32"): "flash_fwd_kernel",
    ("flash_fwd", "bfloat16"): "flash_fwd_tc_kernel",
    ("flash_bwd_dq", "float32"): "flash_bwd_dq_kernel",
    ("flash_bwd_dq", "bfloat16"): "flash_bwd_dq_tc_kernel",
    ("flash_bwd_dkv", "float32"): "flash_bwd_dkv_kernel",
    ("flash_bwd_dkv", "bfloat16"): "flash_bwd_dkv_tc_kernel",
}


def _flash_inputs(case, gen, device):
    """q, k, v, dO laid out as the model makes them ([B, S, H, D] memory
    viewed as [B, H, S, D]), an additive -1e9 padding mask from ragged
    lengths (row 0 all padding with ``pad_row``), and the lengths."""
    import torch

    name, B, H, S, D, dt, masked, causal, window, pad_row, mask_grad = case
    dtype = getattr(torch, dt)

    def mk():
        return torch.randn(B, S, H, D, generator=gen).to(device, dtype).transpose(1, 2)

    q, k, v, do = mk(), mk(), mk(), mk()
    lens = None
    mask = None
    if masked:
        lens = torch.randint(S // 4, S + 1, (B,), generator=gen)
        lens[1] = S
        if pad_row:
            lens[0] = 0
        keep = (torch.arange(S)[None, :] < lens[:, None]).float()
        mask = ((1.0 - keep) * -1e9)[:, None, None, :].to(device)
        if mask_grad:
            mask.requires_grad_(True)
    return dict(q=q, k=k, v=v, do=do, mask=mask), lens


def _flash_work(case, lens) -> dict:
    """Bytes and flops each kernel needs for these inputs. Bytes: every
    input read once and every output written once (q, k, v, o, dO, the
    gradients in the input dtype; LSE, the [B, S] mask and the per-head
    dmask in fp32). Flops: 2·D per (query, key) pair for each of the
    products on the pairs this data needs: a row sees its batch row's
    valid keys (all keys when it has none: the uniform row), the causal
    prefix, or the last ``window`` keys. Forward QKᵀ and PV (4·D), dQ
    adds dPᵀ and dS·K (6·D), dK/dV adds dV and dK (8·D)."""
    name, B, H, S, D, dt, masked, causal, window, pad_row, mask_grad = case
    esz = 2 if dt == "bfloat16" else 4
    rows = range(S)
    if causal:
        per_bh = sum(min(i + 1, window or S) for i in rows)
        pairs = B * H * per_bh
    elif masked:
        pairs = H * S * sum(int(n) if int(n) > 0 else S for n in lens)
    else:
        pairs = B * H * S * S
    t = B * H * S * D * esz
    lse = B * H * S * 4
    mask = B * S * 4 if masked else 0
    return {"flash_fwd": (4 * t + lse + mask, 4 * D * pairs),
            "flash_bwd_dq": (6 * t + lse + mask, 6 * D * pairs),
            "flash_bwd_dkv": (7 * t + lse + mask + (B * H * S * 4 if mask_grad else 0),
                              8 * D * pairs)}


def _sdpa_mask(t, case):
    """The same masking for one ``scaled_dot_product_attention`` call:
    the additive mask in q's dtype, or a banded additive mask."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops.attention import (
        make_banded_causal_mask,
    )

    q = t["q"]
    if case[8] is not None:
        return make_banded_causal_mask(q.shape[2], case[8], device=q.device).to(q.dtype)
    if t["mask"] is not None:
        return t["mask"].detach().to(q.dtype)
    return None


def flash_phase(cases=None) -> dict:
    """Each flash kernel against its plain version on every case
    (``cases``, else ``FLASH_CASES``); times and bounds. Returns the rows
    by (case, kernel)."""
    import torch
    import torch.nn.functional as F

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    fa.load_kernel()
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1)
    results = {}
    with torch.no_grad():
        for case in FLASH_CASES if cases is None else cases:
            results.update(_flash_case(case, gen, dev))
    return results


def _flash_case(case, gen, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    results = {}
    name, B, H, S, D, dt, masked, causal, window, pad_row, mask_grad = case
    sets = [_flash_inputs(case, gen, dev) for _ in range(FLASH_COPIES)]
    t, lens = sets[0]
    kw = dict(causal=causal, window=window)
    # the plain forward's o/LSE are the backward kernels' inputs
    bwd_sets = []
    for s_, _ in sets:
        o_s, lse_s = fa.flash_attention_fwd_reference(s_["q"], s_["k"], s_["v"],
                                                      s_["mask"], **kw)
        bwd_sets.append((s_["q"], s_["k"], s_["v"], s_["mask"], o_s, lse_s, s_["do"]))
    args = bwd_sets[0]
    o_ref, lse_ref = args[4], args[5]
    o, lse = fa.flash_fwd(t["q"], t["k"], t["v"], t["mask"], **kw)
    dq = fa.flash_bwd_dq(*args, **kw)
    dq_ref = fa.flash_bwd_dq_reference(*args, **kw)
    dk, dv, dm = fa.flash_bwd_dkv(*args, **kw, want_dmask=mask_grad)
    dk_ref, dv_ref, dm_ref = fa.flash_bwd_dkv_reference(*args, **kw, want_dmask=mask_grad)
    _sync()
    compared = {"flash_fwd": [(o, o_ref), (lse, lse_ref)],
                "flash_bwd_dq": [(dq, dq_ref)],
                "flash_bwd_dkv": [(dk, dk_ref), (dv, dv_ref)]
                + ([(dm, dm_ref)] if mask_grad else [])}
    # per kernel, the output closest to its limit: its error, limit and max|want|
    errs, limits, want_max = {}, {}, {}
    for kname, pairs in compared.items():
        worst = (-1.0, 0.0, 0.0, 0.0)
        for got, want in pairs:
            g, w = got.float(), want.float()
            e, m = float((g - w).abs().max()), float(w.abs().max())
            lim = _limit(got, m)
            check(bool(torch.isfinite(g).all()) and e <= lim,
                  f"flash case {name}: {kname} max_abs_err {e} over {lim} (max |want| {m})")
            worst = max(worst, (e / lim if lim > 0 else 0.0, e, lim, m))
        _, errs[kname], limits[kname], want_max[kname] = worst
    if pad_row:
        check(bool(torch.isfinite(o[0].float()).all()), "pad_row: non-finite output")

    fwd_sets = [(s_["q"], s_["k"], s_["v"], s_["mask"]) for s_, _ in sets]
    calls = {"flash_fwd": (lambda *a: fa.flash_fwd(*a, **kw), fwd_sets),
             "flash_bwd_dq": (lambda *a: fa.flash_bwd_dq(*a, **kw), bwd_sets),
             "flash_bwd_dkv": (lambda *a: fa.flash_bwd_dkv(*a, **kw, want_dmask=mask_grad),
                               bwd_sets)}
    # device time of the kernel alone (profiler), and CUDA events around
    # a loop of wrapper calls (host gaps included)
    ms = {k: _device_ms(fn, a_, FLASH_KERNEL_NAMES[(k, dt)]) for k, (fn, a_) in calls.items()}
    event_ms = {k: _cuda_ms(fn, a_) for k, (fn, a_) in calls.items()}
    plain = {"flash_fwd": _cuda_ms(
                 lambda *a: fa.flash_attention_fwd_reference(*a, **kw), fwd_sets, iters=10),
             "flash_bwd_dq": _cuda_ms(
                 lambda *a: fa.flash_bwd_dq_reference(*a, **kw), bwd_sets, iters=10),
             "flash_bwd_dkv": _cuda_ms(lambda *a: fa.flash_bwd_dkv_reference(
                 *a, **kw, want_dmask=mask_grad), bwd_sets, iters=10)}
    # the library yardstick: SDPA forward, and its backward via autograd
    lib_sets, lib_bwd = [], []
    for s_, _ in sets:
        qkv = [x.detach().requires_grad_(True) for x in (s_["q"], s_["k"], s_["v"])]
        m = _sdpa_mask(s_, case)
        is_causal = causal and window is None
        lib_sets.append((*qkv, m, is_causal))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*qkv, attn_mask=m, is_causal=is_causal)
        lib_bwd.append((out, qkv, s_["do"]))

    def sdpa(q, k, v, m, is_causal):
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, attn_mask=m, is_causal=is_causal)

    def sdpa_bwd(out, qkv, do):
        with torch.enable_grad():
            torch.autograd.grad(out, qkv, do, retain_graph=True)

    library = {"flash_fwd": _device_ms(sdpa, lib_sets)}
    library["flash_bwd_dq"] = library["flash_bwd_dkv"] = _device_ms(sdpa_bwd, lib_bwd)
    library_event = {"flash_fwd": _cuda_ms(sdpa, lib_sets)}
    library_event["flash_bwd_dq"] = library_event["flash_bwd_dkv"] = _cuda_ms(sdpa_bwd, lib_bwd)
    peak = BF16_FLOPS_PER_S if dt == "bfloat16" else FP32_FLOPS_PER_S
    for kname, (nbytes, flops) in _flash_work(case, lens).items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        row = {"phase": "flash_kernel", "case": name, "kernel": kname,
               "B": B, "H": H, "S": S, "D": D, "dtype": dt, "masked": masked,
               "causal": causal, "window": window, "pad_row": pad_row,
               "mask_grad": mask_grad,
               "lengths": None if lens is None else lens.tolist(),
               "kernel_name": FLASH_KERNEL_NAMES[(kname, dt)],
               "max_abs_err": errs[kname], "max_abs_err_limit": limits[kname],
               "status": "pass",
               "kernel_ms": ms[kname], "kernel_event_ms": event_ms[kname],
               "plain_ms": plain[kname], "library_ms": library[kname],
               "library_event_ms": library_event[kname],
               "library": ("scaled_dot_product_attention forward" if kname == "flash_fwd"
                           else "scaled_dot_product_attention backward (dq, dk, dv)"),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops}
        row["want_max_abs"] = want_max[kname]
        emit(row)
        results[(name, kname)] = row
    del sets, args, fwd_sets, bwd_sets, lib_sets, lib_bwd
    torch.cuda.empty_cache()
    return results


# -- training ----------------------------------------------------------------

# the HF hub's bert-base-uncased/config.json widths
BERT_BASE = {"model_type": "bert", "architectures": ["BertForMaskedLM"],
             "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
             "num_attention_heads": 12, "intermediate_size": 3072,
             "max_position_embeddings": 512, "type_vocab_size": 2,
             "hidden_act": "gelu", "layer_norm_eps": 1e-12,
             "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
             "initializer_range": 0.02, "pad_token_id": 0}
TRAIN_RESULT_KEYS = ["loss", "sparse_categorical_accuracy", "train_runtime",
                     "train_samples_per_second", "train_samples_per_second_per_chip"]
EVAL_RESULT_KEYS = ["eval_loss", "eval_accuracy"]
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_REL_L2 = 1e-3
PARITY_KEY_BIAS = 1e-5
# bf16 step: the loss through the kernels within 2^-6 of the plain bf16
# loss (a few bf16 roundings of the logits), each gradient within 2x the
# plain bf16 path's own distance from fp32 (see train_parity_phase), and
# the key biases' noise below a quarter of one bf16 rounding step (2^-8)
# of the global gradient norm
PARITY_BF16_LOSS_RTOL = 2.0 ** -6
PARITY_BF16_FACTOR = 2.0
PARITY_BF16_KEY_BIAS = 2.0 ** -10
CLI_STEPS = 40
CLI_EVAL_SAMPLES = 64


# the HF hub's config.json widths of the other encoder families this
# script trains (random weights; depth cut where a phase says so)
# bert-large-uncased-whole-word-masking (the reference's default model)
BERT_LARGE = dict(BERT_BASE, hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096)
ROBERTA_BASE = {"model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
                "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
                "num_attention_heads": 12, "intermediate_size": 3072,
                "max_position_embeddings": 514, "type_vocab_size": 1, "hidden_act": "gelu",
                "layer_norm_eps": 1e-5, "hidden_dropout_prob": 0.1,
                "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
                "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2}
DISTILBERT_BASE = {"model_type": "distilbert", "architectures": ["DistilBertForMaskedLM"],
                   "vocab_size": 30522, "dim": 768, "n_layers": 6, "n_heads": 12,
                   "hidden_dim": 3072, "max_position_embeddings": 512, "activation": "gelu",
                   "dropout": 0.1, "attention_dropout": 0.1, "initializer_range": 0.02,
                   "pad_token_id": 0}
ELECTRA_SMALL = {"model_type": "electra", "architectures": ["ElectraForPreTraining"],
                 "vocab_size": 30522, "embedding_size": 128, "hidden_size": 256,
                 "num_hidden_layers": 12, "num_attention_heads": 4, "intermediate_size": 1024,
                 "max_position_embeddings": 512, "type_vocab_size": 2, "hidden_act": "gelu",
                 "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.1,
                 "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
                 "pad_token_id": 0}
# albert-base-v2
ALBERT_BASE = {"model_type": "albert", "architectures": ["AlbertForMaskedLM"],
               "vocab_size": 30000, "embedding_size": 128, "hidden_size": 768,
               "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
               "num_hidden_groups": 1, "inner_group_num": 1, "max_position_embeddings": 512,
               "type_vocab_size": 2, "hidden_act": "gelu_new", "layer_norm_eps": 1e-12,
               "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
               "classifier_dropout_prob": 0.1, "initializer_range": 0.02, "pad_token_id": 0}
# the HF hub's t5-small/config.json (v1.0: ReLU FFN, tied head) and
# facebook/bart-base/config.json widths
T5_SMALL = {"model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
            "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048,
            "num_layers": 6, "num_decoder_layers": 6, "num_heads": 8,
            "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
            "dropout_rate": 0.1, "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
            "tie_word_embeddings": True, "pad_token_id": 0, "eos_token_id": 1,
            "decoder_start_token_id": 0, "initializer_factor": 1.0}
BART_BASE = {"model_type": "bart", "architectures": ["BartForConditionalGeneration"],
             "vocab_size": 50265, "d_model": 768, "encoder_layers": 6, "decoder_layers": 6,
             "encoder_attention_heads": 12, "decoder_attention_heads": 12,
             "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072, "activation_function": "gelu",
             "dropout": 0.1, "attention_dropout": 0.1, "activation_dropout": 0.1,
             "max_position_embeddings": 1024, "init_std": 0.02, "scale_embedding": False,
             "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
             "decoder_start_token_id": 2, "forced_bos_token_id": 0}
# microsoft/deberta-v3-base/config.json widths
DEBERTA_V3_BASE = {"model_type": "deberta-v2", "architectures": ["DebertaV2ForMaskedLM"],
                   "vocab_size": 128100, "hidden_size": 768, "num_hidden_layers": 12,
                   "num_attention_heads": 12, "intermediate_size": 3072,
                   "max_position_embeddings": 512, "type_vocab_size": 0,
                   "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
                   "attention_probs_dropout_prob": 0.1, "initializer_range": 0.02,
                   "layer_norm_eps": 1e-7, "relative_attention": True,
                   "position_buckets": 256, "max_relative_positions": -1,
                   "share_att_key": True, "pos_att_type": "p2c|c2p",
                   "norm_rel_ebd": "layer_norm", "position_biased_input": False,
                   "pooler_dropout": 0, "pooler_hidden_act": "gelu", "pad_token_id": 0}
PARITY_DEPTH = 2                # the other families' parity steps: 2 layers (ALBERT: 2 uses)
S2S_SEQ = 512                   # the seq2seq runs' source length (the CLI's default)
S2S_TARGET = 64                 # and target length (--max_target_length's default)


def _parity_families() -> list:
    """(family, published config) of the families held by one fp32 and one
    bf16 step each at ``PARITY_DEPTH``, beside BERT-base at full depth."""
    return [("roberta", ROBERTA_BASE), ("distilbert", DISTILBERT_BASE),
            ("electra", ELECTRA_SMALL), ("albert", ALBERT_BASE)]


def _review_batch(n: int, seq: int, device, split: str = "train",
                  vocab: int | None = None) -> dict:
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    texts, labels = load_text_classification("vendored_reviews", split, max_samples=n)
    enc = WordHashTokenizer(vocab_size=vocab or BERT_BASE["vocab_size"])(texts, max_length=seq)
    return {"input_ids": torch.from_numpy(enc["input_ids"]).long().to(device),
            "attention_mask": torch.from_numpy(enc["attention_mask"]).long().to(device),
            "labels": torch.tensor(labels).long().to(device)}


# the CPU draws of the parity steps' weights, one a model shape
_SEEDED: dict = {}


def _seeded(init, family: str, task: str, cfg):
    """``init(auto.build_model(family, task, cfg), seed=0, device=DEVICE)``
    in train mode, its weights drawn on the CPU once per model shape: the
    compute dtype and the attention path change no weight, so a parity
    pair's four steps share one draw (``train_parity_phase`` empties the
    cache)."""
    import dataclasses

    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto

    key = (init.__name__, family, task,
           repr(dataclasses.replace(cfg, dtype=torch.float32, attention_impl="xla")))
    if key not in _SEEDED:
        _SEEDED[key] = init(auto.build_model(family, task, cfg), seed=0,
                            device="cpu").state_dict()
    with torch.device("meta"):
        model = auto.build_model(family, task, cfg)
    model.load_state_dict({k: v.to(DEVICE, copy=True) for k, v in _SEEDED[key].items()},
                          assign=True)
    return model.train()


def _encoder_step(family: str, hf: dict, batch, impl: str, dtype,
                  layers: int | None = None) -> tuple[float, dict]:
    """One seq-cls train step of ``family`` at the widths of ``hf`` (depth
    ``layers`` when given) from seed 0, dropout 0: the loss and every
    parameter's gradient (fp32 parameters)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        seq_cls_loss,
    )

    over = dict(hidden_dropout=0.0, attention_dropout=0.0, classifier_dropout=0.0,
                attention_impl=impl, dtype=dtype)
    if layers:
        over["num_layers"] = layers
    cfg = auto.CONFIG_BUILDERS[family](hf, **over)
    model = _seeded(init_encoder, family, "seq-cls", cfg)
    loss, _ = seq_cls_loss(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def _pretrain_batch(n: int, seq: int, device, vocab: int, task: str) -> dict:
    """``n`` training reviews as an MLM batch (whole-word masks from seed
    0) or an RTD batch (random replacements from seed 0)."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
        ArrayDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    texts, _ = load_text_classification("vendored_reviews", "train", max_samples=n)
    tok = WordHashTokenizer(vocab_size=vocab)
    build = ArrayDataset.from_mlm_texts if task == "mlm" else ArrayDataset.from_rtd_texts
    rows = build(tok, texts, seq, seed=0)[np.arange(n)]
    return {k: torch.from_numpy(np.asarray(v)).long().to(device) for k, v in rows.items()}


def _pretrain_step(family: str, hf: dict, batch, task: str, kernels: bool, dtype,
                   layers: int) -> tuple[float, dict]:
    """One ``mlm`` or ``rtd`` train step of ``family`` at the widths of
    ``hf`` and depth ``layers`` from seed 0, dropout 0: with ``kernels``
    the flash attention and, for MLM, the sparse-gather fused vocab CE (K1
    and K2 in one step); else the plain attention and the unfused logits
    and CE. The loss and every parameter's gradient (fp32 parameters)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as tr

    over = dict(hidden_dropout=0.0, attention_dropout=0.0, num_layers=layers, dtype=dtype,
                attention_impl="flash" if kernels else "xla")
    if family in ("bert", "albert"):
        over["use_pooler"] = False          # HF's MLM models have no pooler
    cfg = auto.CONFIG_BUILDERS[family](hf, **over)
    model = _seeded(init_encoder, family, task, cfg)
    if task == "rtd":
        loss_fn = tr.rtd_loss
    else:
        loss_fn = (tr.make_fused_mlm_loss(TrainConfig.fused_mlm_mask_cap) if kernels
                   else tr.TASK_LOSSES["mlm"])
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _seq2seq_batch(n: int, vocab: int, ids: dict, device) -> dict:
    """``n`` synthetic summarization pairs (seed 0) as a seq2seq batch at
    ``S2S_SEQ`` / ``S2S_TARGET``, the hash tokenizer at ``vocab``, with the
    model's decoder start, pad and EOS ids."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
        ArrayDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        synthetic_summarization,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    docs, sums = synthetic_summarization(n, seed=0)
    rows = ArrayDataset.from_seq2seq(WordHashTokenizer(vocab_size=vocab), docs, sums,
                                     max_source_length=S2S_SEQ, max_target_length=S2S_TARGET,
                                     **ids)[np.arange(n)]
    return {k: torch.from_numpy(np.asarray(v)).long().to(device) for k, v in rows.items()}


def _seq2seq_step(family: str, hf: dict, batch, kernels: bool, dtype,
                  layers: int) -> tuple[float, dict]:
    """One seq2seq train step of ``family`` (``t5`` or ``bart``) at the
    widths of ``hf`` and ``layers`` encoder and decoder layers from seed 0,
    dropout 0, label smoothing 0.1: with ``kernels`` the fused seq2seq
    loss (K2), else the unfused logits and the smoothed CE. The loss and
    every parameter's gradient (fp32 parameters)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_seq2seq,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as tr

    if family == "t5":
        over = dict(num_layers=layers, num_decoder_layers=layers, dropout_rate=0.0)
    else:
        over = dict(encoder_layers=layers, decoder_layers=layers, dropout=0.0,
                    attention_dropout=0.0, activation_dropout=0.0)
    cfg = auto.CONFIG_BUILDERS[family](hf, dtype=dtype, **over)
    model = _seeded(init_seq2seq, family, "seq2seq", cfg)
    loss_fn = (tr.make_fused_seq2seq_loss(0.1) if kernels
               else lambda m, b: tr.seq2seq_loss(m, b, epsilon=0.1))
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def train_parity_phase() -> dict:
    """(a) one fp32 and one bf16 BERT-base train step, flash kernels
    against the plain attention; then the same for RoBERTa-base,
    DistilBERT-base, ELECTRA-small and ALBERT-base-v2 at their widths and
    ``PARITY_DEPTH``; then an MLM step of each of the five families at
    ``PARITY_DEPTH`` through the flash kernels and the fused MLM loss (K1
    and K2) against the plain attention and the unfused logits, and
    ELECTRA-small's RTD step; then a T5-small and a BART-base seq2seq step
    at ``PARITY_DEPTH`` + ``PARITY_DEPTH`` through the fused seq2seq loss
    (K2, smoothing 0.1) against the unfused logits. Returns the rows by
    dtype (``"<family>/<dtype>"`` for the other families,
    ``"<family>-<task>/<dtype>"`` for the pretraining and seq2seq
    steps)."""
    import torch

    rows = {}
    t0 = time.perf_counter()
    for family, hf, layers in [("bert", BERT_BASE, None)] + [
            (f, hf, PARITY_DEPTH) for f, hf in _parity_families()]:
        batch = _review_batch(8, 512, DEVICE, vocab=hf["vocab_size"])
        steps = {(dt, impl): _encoder_step(family, hf, batch, impl, getattr(torch, dt), layers)
                 for dt in ("float32", "bfloat16") for impl in ("flash", "xla")}
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        model = ("bert-base-uncased widths" if family == "bert"
                 else f"{family} widths ({hf['model_type']} config, depth {layers})")
        depth = layers or hf["num_hidden_layers"]
        pair = _parity_rows(model, depth, steps, one_dof_apart=family != "bert")
        rows.update(pair if family == "bert"
                    else {f"{family}/{dt}": row for dt, row in pair.items()})
    t1 = time.perf_counter()
    for family, hf, task in [("bert", BERT_BASE, "mlm")] + [
            (f, hf, "mlm") for f, hf in _parity_families()] + [
            ("electra", ELECTRA_SMALL, "rtd")]:
        batch = _pretrain_batch(8, 512, DEVICE, hf["vocab_size"], task)
        steps = {(dt, impl): _pretrain_step(family, hf, batch, task, impl == "flash",
                                            getattr(torch, dt), PARITY_DEPTH)
                 for dt in ("float32", "bfloat16") for impl in ("flash", "xla")}
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        kernels = "flash + fused MLM CE" if task == "mlm" else "flash"
        model = (f"{family} {task} ({hf['model_type']} config widths, depth "
                 f"{PARITY_DEPTH}; {kernels} against the plain path)")
        pair = _parity_rows(model, PARITY_DEPTH, steps, one_dof_apart=True)
        rows.update({f"{family}-{task}/{dt}": row for dt, row in pair.items()})
    t2 = time.perf_counter()
    for family, hf in (("t5", T5_SMALL), ("bart", BART_BASE)):
        ids = {k: hf[k] for k in ("decoder_start_token_id", "pad_token_id", "eos_token_id")}
        batch = _seq2seq_batch(8, hf["vocab_size"], ids, DEVICE)
        steps = {(dt, impl): _seq2seq_step(family, hf, batch, impl == "flash",
                                           getattr(torch, dt), PARITY_DEPTH)
                 for dt in ("float32", "bfloat16") for impl in ("flash", "xla")}
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        model = (f"{family} seq2seq ({hf['model_type']} config widths, depth {PARITY_DEPTH} + "
                 f"{PARITY_DEPTH}; the fused seq2seq loss, smoothing 0.1, against the "
                 "unfused logits)")
        pair = _parity_rows(model, PARITY_DEPTH, steps)
        rows.update({f"{family}-seq2seq/{dt}": row for dt, row in pair.items()})
    t3 = time.perf_counter()
    rows.update(_breadth_parity())
    _SEEDED.clear()
    emit({"phase": "train_parity_wall", "encoder_steps_s": t1 - t0,
          "pretrain_steps_s": t2 - t1, "seq2seq_steps_s": t3 - t2,
          "lora_packing_deberta_steps_s": time.perf_counter() - t3})
    return rows


LORA_RANK = 8
LORA_ALPHA = 16.0


def _lora_step(batch, impl: str, dtype) -> tuple[float, dict]:
    """One BERT-base seq-cls train step with LoRA r ``LORA_RANK`` on the
    attention kernels (A from seed 0, B drawn at 0.02 from seed 1 so A's
    gradient is not 0), the base frozen but the pooler and classifier,
    dropout 0: the loss and the gradients of the adapters and heads. Fails
    if a frozen base weight took a gradient."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import lora as lo
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        seq_cls_loss,
    )

    cfg = auto.CONFIG_BUILDERS["bert"](BERT_BASE, hidden_dropout=0.0, attention_dropout=0.0,
                                       classifier_dropout=0.0, attention_impl=impl,
                                       dtype=dtype)
    model = _seeded(init_encoder, "bert", "seq-cls", cfg)
    lora = lo.init_lora_params(model, LORA_RANK, "attention", seed=0)
    gen = torch.Generator().manual_seed(1)
    for ab in lora.values():
        ab["b"] = (torch.randn(ab["b"].shape, generator=gen) * 0.02).to(DEVICE)
        for t in ab.values():
            t.requires_grad_(True)
    heads = lo.freeze_base(model, lo.HEAD_REGEX_DEFAULT)
    lo.attach_lora(model, lora, lo.lora_scaling(LORA_RANK, LORA_ALPHA))
    loss, _ = seq_cls_loss(model, batch)
    loss.backward()
    took = [n for n, p in model.named_parameters() if n not in heads and p.grad is not None]
    check(not took, f"LoRA parity: frozen base weights took gradients: {took[:4]}")
    grads = {f"{path}/{k}": t.grad.detach().clone() for path, ab in lora.items()
             for k, t in ab.items()}
    grads.update({n: model.get_parameter(n).grad.detach().clone() for n in heads})
    return float(loss.detach()), grads


def _packed_lm_batch(n: int, seq: int, device) -> dict:
    """The training reviews as causal-LM rows packed behind segment ids
    (``pack_examples(causal=True)``), the first ``n`` packed rows."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
        ArrayDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    # the reviews average 45 tokens: about 11 share a row of 512
    texts, _ = load_text_classification("vendored_reviews", "train", max_samples=32 * n)
    ds = ArrayDataset.from_lm_texts(WordHashTokenizer(vocab_size=GPT2_124M["vocab_size"]),
                                    texts, seq).pack(seq, causal=True)
    check(len(ds) >= n, f"{len(ds)} packed rows, wanted {n}")
    return {k: torch.from_numpy(np.asarray(v)).long().to(device)
            for k, v in ds[np.arange(n)].items()}


def _breadth_parity() -> dict:
    """The train parity phase's LoRA, packing and DeBERTa steps, each fp32
    and bf16 from the same weights, kernels against the plain path:
    BERT-base seq-cls with LoRA r 8 on the attention kernels (K1's forward,
    dQ and dK/dV against the plain attention; the adapters' and heads'
    gradients, the base frozen); GPT-2 124M on segment-packed rows (the
    fused causal-LM loss, K2, against the unfused logits; the segment mask
    sends both to the plain attention, so K1 must not launch); DeBERTa-v3-
    base widths at ``PARITY_DEPTH``, MLM through the fused loss at V 128100
    against the unfused logits (no K1)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    rows = {}
    batch = _review_batch(8, 512, DEVICE)
    steps = {(dt, impl): _lora_step(batch, impl, getattr(torch, dt))
             for dt in ("float32", "bfloat16") for impl in ("flash", "xla")}
    pair = _parity_rows(f"bert-base seq-cls, LoRA r {LORA_RANK} on attention (flash against "
                        "the plain attention; adapter and head gradients)",
                        BERT_BASE["num_hidden_layers"], steps, one_dof_apart=True)
    rows.update({f"bert-lora/{dt}": row for dt, row in pair.items()})
    for mod_k in _K1:
        getattr(fa, mod_k).launches = 0
    for name, make, step in (
            ("gpt2-segment-packing", lambda: _packed_lm_batch(8, GPT2_SEQ, DEVICE),
             lambda b, impl, dt: _gpt2_step(b, impl, dt)),
            ("deberta-mlm", lambda: _pretrain_batch(8, 512, DEVICE,
                                                    DEBERTA_V3_BASE["vocab_size"], "mlm"),
             lambda b, impl, dt: _pretrain_step("deberta-v2", DEBERTA_V3_BASE, b, "mlm",
                                                impl == "flash", dt, PARITY_DEPTH))):
        batch = make()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        steps = {(dt, impl): step(batch, impl, getattr(torch, dt))
                 for dt in ("float32", "bfloat16") for impl in ("flash", "xla")}
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        if name.startswith("gpt2"):
            model, layers = ("gpt2 124M widths on segment-packed rows (the fused causal-LM "
                             "loss against the unfused logits)"), GPT2_124M["n_layer"]
        else:
            model, layers = (f"deberta-v3-base widths, depth {PARITY_DEPTH}, mlm (the fused "
                             "MLM loss at V 128100 against the unfused logits)"), PARITY_DEPTH
        pair = _parity_rows(model, layers, steps,
                            exact_zero=("key.bias",) if name.startswith("gpt2") else ())
        rows.update({f"{name}/{dt}": row for dt, row in pair.items()})
    k1 = {k: getattr(fa, k).launches for k in _K1}
    check(not any(k1.values()), f"K1 launched on segment-packed or DeBERTa steps: {k1}")
    return rows


def _parity_rows(model: str, layers: int, steps: dict, one_dof_apart: bool = False,
                 exact_zero: tuple = ("key.bias",)) -> dict:
    """Hold a model's fp32 flash step to its plain step and its bf16 flash
    step to fp32 as close as the plain bf16 step; emit both rows.

    With ``one_dof_apart`` the two-label classifier's bias, and the RTD
    head's one-logit ``disc_prediction`` bias, are held to the whole step's
    bf16 gate instead of their own: the classifier bias's two entries are
    each other's negatives and the RTD bias is one number, so each one's
    distance from fp32 is one rounding draw, and the ratio of two such
    draws of equal spread exceeds 2 about 30% of the time (RoBERTa's at
    depth 2 read 3.10 on the card while that step's loss was closer to
    fp32 through the kernels than without). The MLM head's bias ``[V]``
    has many degrees of freedom and keeps its own gate.

    ``exact_zero`` names (by suffix) the parameters whose exact gradient is
    0, held apart as described below: the key biases of a softmax over the
    keys. DeBERTa passes none: its position-to-content term multiplies the
    key bias by a position query that varies along the keys."""
    import torch

    (loss32, g32), (loss_ref, ref) = steps[("float32", "flash")], steps[("float32", "xla")]
    rel_loss = abs(loss32 - loss_ref) / abs(loss_ref)
    # each parameter's relative L2 error. The key biases (BART's
    # cross-attention's too; T5 has none) are held apart: their exact
    # gradient is 0 (softmax ignores a per-row constant), so both sides
    # hold rounding noise, which must stay below 1e-5 of the global
    # gradient norm
    total = float(torch.sqrt(sum((g.float() ** 2).sum() for g in ref.values())))
    key_bias = [n for n in g32 if exact_zero and n.endswith(exact_zero)]
    noise = max((float(g[n].norm()) for g in (g32, ref) for n in key_bias),
                default=0.0) / total
    rel = {n: float((g - ref[n]).norm() / ref[n].norm())
           for n, g in g32.items() if n not in key_bias}
    worst = max(rel, key=rel.get)
    row = {"phase": "train_parity", "model": model, "layers": layers,
           "batch": 8, "seq": 512, "dtype": "float32", "tf32": False,
           "loss_flash": loss32, "loss_plain": loss_ref,
           "loss_rel_err": rel_loss, "loss_rtol": PARITY_LOSS_RTOL,
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
           "grad_rel_l2_tol": PARITY_GRAD_REL_L2, "params": len(rel),
           "key_bias_grad_norm_over_global": noise, "key_bias_tol": PARITY_KEY_BIAS}
    emit(row)
    check(rel_loss <= PARITY_LOSS_RTOL, f"train parity ({model}): loss rel err {rel_loss}")
    check(rel[worst] <= PARITY_GRAD_REL_L2,
          f"train parity ({model}): {worst} grad rel L2 {rel[worst]}")
    check(noise <= PARITY_KEY_BIAS, f"train parity ({model}): key-bias gradient noise {noise}")

    # bf16: the flash step (tensor-core forward and dK/dV, CUDA-core dQ)
    # and the plain bf16 step, each against the fp32 plain step. Every
    # parameter's gradient through the kernels may be no further from the
    # fp32 one than PARITY_BF16_FACTOR x the plain bf16 attention's
    # distance, plus the fp32 noise floor (PARITY_KEY_BIAS x the global
    # norm): the kernels may add no error beyond what bf16 rounding gives
    # the plain path. The key biases (exact gradient 0) are held apart: on
    # both sides their bf16 rounding noise (dK is rounded to bf16 per
    # element before it is summed over 4096 tokens) must stay below
    # PARITY_BF16_KEY_BIAS of the global norm.
    (loss16, g16), (loss16_ref, ref16) = (steps[("bfloat16", "flash")],
                                          steps[("bfloat16", "xla")])
    floor = PARITY_KEY_BIAS * total
    dist = {n: float((g16[n] - ref[n]).norm()) for n in ref}
    dist_plain = {n: float((ref16[n] - ref[n]).norm()) for n in ref}
    one_dof = [n for n in ref if one_dof_apart and (
        (n.endswith("classifier.bias") and ref[n].numel() == 2)
        or (n.endswith("disc_prediction.bias") and ref[n].numel() == 1))]

    def over(d, d_plain):
        return ((d - floor) / d_plain if d_plain > 0 else
                (0.0 if d <= floor else float("inf")))

    ratio = {n: over(dist[n], dist_plain[n]) for n in ref if n not in key_bias + one_dof}
    worst16 = max(ratio, key=ratio.get)
    # the whole step: every gradient but the key biases' as one vector
    step_ratio = over(math.sqrt(sum(dist[n] ** 2 for n in ref if n not in key_bias)),
                      math.sqrt(sum(dist_plain[n] ** 2 for n in ref if n not in key_bias)))
    noise16 = {i: max((float(g[n].norm()) for n in key_bias), default=0.0) / total
               for i, g in (("flash", g16), ("plain", ref16))}
    rel16 = {n: float((g16[n] - ref16[n]).norm() / ref16[n].norm())
             for n in ref if n not in key_bias}
    loss_rel16 = abs(loss16 - loss16_ref) / abs(loss16_ref)
    row16 = {"phase": "train_parity", "model": model, "layers": layers,
             "batch": 8, "seq": 512, "dtype": "bfloat16",
             "loss_flash": loss16, "loss_plain": loss16_ref, "loss_fp32": loss_ref,
             "loss_rel_err": loss_rel16, "loss_rtol": PARITY_BF16_LOSS_RTOL,
             "grad_dist_ratio_max": ratio[worst16], "grad_dist_ratio_worst_param": worst16,
             "grad_dist_ratio_tol": PARITY_BF16_FACTOR,
             "grad_dist_ratio_top5": sorted(ratio.values(), reverse=True)[:5],
             "grad_dist_step_ratio": step_ratio,
             "one_dof_held_apart": {n: over(dist[n], dist_plain[n]) for n in one_dof},
             "key_bias_grad_norm_over_global": noise16,
             "key_bias_tol": PARITY_BF16_KEY_BIAS,
             "flash_vs_fp32_rel_l2_max": max(dist[n] / ref[n].norm().item()
                                             for n in ref if n not in key_bias),
             "plain_vs_fp32_rel_l2_max": max(dist_plain[n] / ref[n].norm().item()
                                             for n in ref if n not in key_bias),
             "flash_vs_plain_rel_l2_max": max(rel16.values()), "params": len(ratio)}
    emit(row16)
    check(loss_rel16 <= PARITY_BF16_LOSS_RTOL,
          f"bf16 train parity ({model}): loss rel err {loss_rel16}")
    check(ratio[worst16] <= PARITY_BF16_FACTOR,
          f"bf16 train parity ({model}): {worst16} gradient is {dist[worst16]} from fp32, "
          f"plain bf16 {dist_plain[worst16]} (floor {floor})")
    check(max(noise16.values()) <= PARITY_BF16_KEY_BIAS,
          f"bf16 train parity ({model}): key-bias gradient noise {noise16}")
    check(step_ratio <= PARITY_BF16_FACTOR,
          f"bf16 train parity ({model}): the step's gradient is {step_ratio}x as far "
          "from fp32 as the plain bf16 step's")
    return {"float32": row, "bfloat16": row16}


def _device_seconds_by_kernel(prof) -> dict:
    """Device seconds by record name in a profiled window: the durations of
    its device records (kernels, copies, fills) summed straight off the
    profiler's kineto results, the sums ``key_averages`` gives as each
    name's ``self_device_time_total`` without the event tree it builds
    first (seconds of host time for a window of a few thousand launches;
    ``_key_averaged_seconds`` is that route, which the serve_router phase
    holds this one to once)."""
    return {k: s for k, (s, _) in _device_records(prof).items()}


def _device_records(prof) -> dict:
    """Per record name of a profiled window: (device seconds, records),
    straight off the profiler's kineto results."""
    import torch

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            secs, n = out.get(e.name(), (0.0, 0))
            out[e.name()] = (secs + e.duration_ns() / 1e9, n + 1)
    return out


def _pooled_ms(windows: list, iters: int) -> tuple[float, int]:
    """Device ms per call over profiled windows of ``iters`` calls each
    (each window ``{name: (seconds, records)}``), and the records lost:
    each name's mean duration over every window times the most records
    one window held of it. A record the profiler drops then costs its name
    one sample of its mean, not a call's time."""
    names = {n for w in windows for n in w}
    most = {n: max(w.get(n, (0.0, 0))[1] for w in windows) for n in names}
    ms = sum(sum(w[n][0] for w in windows if n in w) / sum(w[n][1] for w in windows if n in w)
             * most[n] for n in names) / iters * 1e3
    lost = sum(most[n] * len(windows) - sum(w.get(n, (0.0, 0))[1] for w in windows)
               for n in names)
    return ms, lost


def _key_averaged_seconds(prof) -> dict:
    """``_device_seconds_by_kernel`` through the profiler's ``key_averages``."""
    import torch

    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e6
    return by_kernel


def _device_busy_s(prof) -> float:
    """The device's busy seconds in a profiled window."""
    return sum(_device_seconds_by_kernel(prof).values())


def _timed_then_profiled(trainer, batches: list) -> tuple[float, dict]:
    """One train step on each of ``batches``, twice: the wall unprofiled,
    then each kernel's device seconds from a profiled pass (the device's
    idle share over the steps is ``1 - busy / wall``)."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    t1 = time.perf_counter()
    for b_ in batches:
        trainer.train_step(b_)
    _sync()
    wall = time.perf_counter() - t1
    with profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        for b_ in batches:
            trainer.train_step(b_)
        _sync()
    return wall, _device_seconds_by_kernel(prof)


def _train_argv(work: Path, out_dir: Path, model_dir: Path) -> list:
    """The train phase's CLI run: BERT-base widths from a config, the
    CLI's defaults, one epoch of ``CLI_STEPS`` steps."""
    cfg_dir = work / "config"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.json").write_text(json.dumps(BERT_BASE))
    return ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
            "--dataset", "vendored_reviews", "--epochs", "1",
            "--steps_per_epoch", str(CLI_STEPS),
            "--max_eval_samples", str(CLI_EVAL_SAMPLES),
            "--output_data_dir", str(out_dir), "--model_dir", str(model_dir),
            "--log_every_steps", "10", "--device", DEVICE]


def train_cli_phase(work: Path) -> dict:
    """(b) the training CLI's main path at its defaults, counted."""
    import math

    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    out_dir, model_dir = work / "output", work / "model"
    argv = _train_argv(work, out_dir, model_dir)
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    t0 = time.perf_counter()
    results, trainer = cli.run(argv)
    _sync()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd_dq.launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
    cfg = trainer.model.config
    train_steps = trainer.step
    eval_steps = math.ceil(CLI_EVAL_SAMPLES / trainer.config.eval_batch_size)
    L = cfg.num_layers
    check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
          and trainer.config.max_seq_length == 512 and trainer.config.train_batch_size == 8
          and trainer.config.eval_batch_size == 4, "the CLI did not run at its defaults")
    check(train_steps == CLI_STEPS, f"{train_steps} train steps, wanted {CLI_STEPS}")
    check(launches["flash_fwd"] == L * (train_steps + eval_steps),
          f"flash_fwd launches {launches['flash_fwd']} != {L} x "
          f"({train_steps} + {eval_steps})")
    for k in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[k] == L * train_steps,
              f"{k} launches {launches[k]} != {L} x {train_steps}")
    hist, ev = results["train"], results["eval"]
    check(all(math.isfinite(x) for x in hist["loss"]) and math.isfinite(ev["eval_loss"]),
          "non-finite loss")
    tr = read_results_file(str(out_dir / "train_results.txt"))
    er = read_results_file(str(out_dir / "eval_results.txt"))
    check(list(tr) == TRAIN_RESULT_KEYS, f"train_results.txt keys {list(tr)}")
    check(list(er) == EVAL_RESULT_KEYS, f"eval_results.txt keys {list(er)}")

    # the export reloads into the port with identical logits
    batch = _review_batch(4, 512, DEVICE, split="test")
    reloaded, _, _ = auto.from_pretrained(str(model_dir), dtype=torch.bfloat16,
                                          device=DEVICE, attention_impl="flash")
    model = trainer.model.eval()
    with torch.no_grad():
        a = model(batch["input_ids"], batch["attention_mask"])
        b = reloaded(batch["input_ids"], batch["attention_mask"])
    check(torch.equal(a, b), "reloaded model.safetensors gives other logits")
    del reloaded

    # the device's idle share over more train steps: wall unprofiled, then
    # device busy time from a profiled run of as many steps
    extra = [_review_batch(8, 512, DEVICE)] * 6
    steps_wall, by_kernel = _timed_then_profiled(trainer, extra)
    busy = sum(by_kernel.values())
    flash_s = {k: sum(v for n, v in by_kernel.items()
                      if FLASH_KERNEL_NAMES[(k, "bfloat16")] in n)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if DEVICE == "cuda":   # the profile names the kernels the train step ran
        for k, sec in flash_s.items():
            check(sec > 0, f"no {FLASH_KERNEL_NAMES[(k, 'bfloat16')]} in the BERT train profile")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    row = {"phase": "train", "model": "bert-base-uncased widths (random init, seed 42)",
           "layers": L, "dtype": "bfloat16", "seq": 512, "batch": 8, "eval_batch": 4,
           "optimizer": trainer.config.optimizer, "train_steps": train_steps,
           "eval_steps": eval_steps, "launches": launches,
           "loss": hist["loss"], "eval_loss": ev["eval_loss"],
           "eval_accuracy": ev["eval_accuracy"],
           "train_samples_per_second_per_chip": hist["train_samples_per_second_per_chip"],
           "step_time_s": trainer.meter.avg_step_time,
           "train_runtime_s": hist["train_runtime"], "cli_wall_s": wall,
           "profiled_steps": len(extra), "steps_wall_s": steps_wall,
           "step_time_unprofiled_s": steps_wall / len(extra),
           "device_busy_s": busy if busy else "not measured",
           "idle_share": 1.0 - busy / steps_wall if busy else "not measured",
           "flash_kernel_s": flash_s,
           "flash_share_of_busy": sum(flash_s.values()) / busy if busy else "not measured",
           "top_kernels_s": [[k[:80], v] for k, v in top]}
    emit(row)
    return row


# -- the trainer's lifecycle ---------------------------------------------------

LIFECYCLE_EPOCHS = 2
LIFECYCLE_STEPS = 12            # per epoch
LIFECYCLE_EVAL_SAMPLES = 32
LIFECYCLE_CKPT_EVERY = 5
LIFECYCLE_STOP_AFTER = 8        # the interrupted run stops after epoch 0 step 7
LIFECYCLE_SPANS = ("train/step_dispatch", "train/sync", "train/checkpoint")
LIFECYCLE_PROFILED = (3, 6)     # the --profile window: a fit's 4th to 7th steps
# added to the eval loss of epoch 1, so that epoch 0 is the best and
# keep-best has to load it back over the last epoch's weights
LIFECYCLE_WORSE_EVAL = 1.0
# how far the resumed run's fp32 weights may be from the uninterrupted
# run's. Two uninterrupted fits already differ on the card, in ulps of the
# token-type embedding (its gradient sums every token into one row in no
# fixed order; "rerun_weight_drift" reads it); state lost in a resume would
# move weights by the order of a learning-rate step (5e-5)
RESUME_WEIGHT_TOL = 1e-6
# the train phase's run, rerun in this order
RERUN_TELEMETRY = (False, True)


class _Interrupt(Exception):
    """The injected stop of the lifecycle phase's interrupted run."""


def _events(tel: Path) -> list:
    return [json.loads(line) for line in (tel / "events.jsonl").read_text().splitlines()]


def _span_s(events: list, name: str) -> list:
    return [e["dur"] for e in events if e["type"] == "span" and e["name"] == name]


def _windows_without_profile(events: list) -> dict:
    """Samples/s and MFU over the meter's windows that hold none of the
    profiled steps. Each ``train/step_time_s`` event closes a window; its
    step is the fit's step count at the close, the first step (excluded
    from the meter) counted, so the windows' step counts are the
    differences."""
    metrics = {(e["name"], e["step"]): e["value"] for e in events
               if e["type"] == "metric" and "step" in e}
    prev, steps, samples, dt, mfu_dt = 1, 0, 0.0, 0.0, 0.0
    lo, hi = LIFECYCLE_PROFILED
    for name, end in list(metrics):
        if name != "train/step_time_s":
            continue
        n, first = end - prev, prev
        prev = end
        if first <= hi and first + n - 1 >= lo:
            continue
        w_dt = n * metrics[(name, end)]
        steps += n
        dt += w_dt
        samples += metrics[("train/samples_per_sec", end)] * w_dt
        mfu_dt += metrics.get(("train/mfu", end), 0.0) * w_dt
    return {"steps": steps, "samples_per_s": samples / dt if dt else "not measured",
            "mfu": mfu_dt / dt if dt and mfu_dt else "not measured"}


def _weight_drift(a: dict, b: dict) -> dict:
    """The largest |difference| of each tensor of ``a`` that is not
    bitwise equal to ``b``'s."""
    import torch

    return {k: float((v.float() - b[k].float()).abs().max())
            for k, v in a.items() if not torch.equal(v, b[k])}


def _step_split(events: list, hist: dict) -> dict:
    """One run's step wall time split between the spans (the first step's
    dispatch, which builds the kernels, apart), with the run's throughput,
    the meter's window step times, and the throughput of the windows
    without the profiled steps."""
    dispatch = _span_s(events, "train/step_dispatch")
    span_s = {n: sum(_span_s(events, n)) for n in LIFECYCLE_SPANS}
    span_s["train/step_dispatch"] -= dispatch[0]
    steps_s = sum(span_s.values())
    return {"first_step_dispatch_s": dispatch[0], "span_s": span_s,
            "span_share": {n: s / steps_s for n, s in span_s.items()},
            "eval_s": sum(_span_s(events, "eval/run") + _span_s(events, "eval/sync")),
            "train_runtime_s": hist["train_runtime"],
            "train_samples_per_second_per_chip": hist["train_samples_per_second_per_chip"],
            "train_mfu": hist.get("train_mfu", "not measured"),
            "step_time_ms": [1e3 * e["value"] for e in events if e["type"] == "metric"
                             and e["name"] == "train/step_time_s"],
            "without_profiled_windows": _windows_without_profile(events)}


def train_lifecycle_phase(work: Path, card: str, rerun_of: Path) -> dict:
    """The training CLI's lifecycle at BERT-base width and its defaults
    (bf16, sequence 512, batch 8, AdamW) with checkpoints every 5 steps
    (2 kept), keep-best, early stopping (patience 1), ``--profile`` and
    telemetry on: (1) an uninterrupted run of 2 epochs x 12 steps with
    async saves, (2) the same run stopped after epoch 0 step 7 (its last
    checkpoint is step 5), (3) the rerun, resumed from step 5 with sync
    saves, and (4) the train phase's run twice, telemetry off, then on,
    which reads the telemetry's own cost on the step and, against the
    train phase's export in ``rerun_of``, how far two identical fits'
    weights drift apart. Epoch 1's eval loss is scripted
    worse, so keep-best has to load epoch 0's weights back. Checks the
    resumed losses equal the uninterrupted run's from step 5 on, bit for
    bit; the flash launches of each run; the profile trace's kernel names;
    the final eval and the export against epoch 0's weights; every
    telemetry event against the schema."""
    import math

    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.safetensors_io import (
        load_file,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.schema import (
        validate_events_file,
        validate_trace_file,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    cfg_dir, ckpt_dir = work / "config", work / "ckpt"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.json").write_text(json.dumps(BERT_BASE))
    common = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
              "--dataset", "vendored_reviews", "--epochs", str(LIFECYCLE_EPOCHS),
              "--steps_per_epoch", str(LIFECYCLE_STEPS),
              "--max_eval_samples", str(LIFECYCLE_EVAL_SAMPLES),
              "--checkpoint_every_steps", str(LIFECYCLE_CKPT_EVERY), "--keep_checkpoints", "2",
              "--keep_best", "true", "--early_stopping_patience", "1", "--profile", "true",
              "--log_every_steps", "4", "--device", DEVICE]

    rec: dict = {}
    orig_step, orig_eval = Trainer.train_step, Trainer.evaluate

    def train_step(self, batch):
        if len(rec["losses"]) == rec["stop_after"]:
            raise _Interrupt
        out = orig_step(self, batch)
        rec["losses"].append(out["loss"])
        return out

    def evaluate(self, batcher):
        # the weights each eval saw: the export is checked against the best
        rec["weights"].append({k: v.detach().to("cpu", copy=True)
                               for k, v in self.model.state_dict().items()})
        res = orig_eval(self, batcher)
        if len(rec["weights"]) == 2:     # epoch 1's eval
            res = dict(res, eval_loss=res["eval_loss"] + LIFECYCLE_WORSE_EVAL)
        return res

    def run(name: str, ckpt: Path, extra: list, stop_after=None):
        rec.update(losses=[], weights=[], stop_after=stop_after)
        tel, prof = work / f"tel_{name}", work / f"prof_{name}"
        obs.reset(out_dir=str(tel))
        fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        out = {"tel": tel, "prof": prof, "results": None, "trainer": None}
        t0 = time.perf_counter()
        try:
            out["results"], out["trainer"] = cli.run(
                common + ["--checkpoint_dir", str(ckpt), "--profile_dir", str(prof),
                          "--output_data_dir", str(work / f"out_{name}"),
                          "--model_dir", str(work / f"model_{name}")] + extra)
        except _Interrupt:
            out["interrupted"] = True
        finally:
            obs.reset()
        _sync()
        out.update(wall_s=time.perf_counter() - t0, losses=list(rec["losses"]),
                   weights=list(rec["weights"]),
                   launches={"flash_fwd": fa.flash_fwd.launches,
                             "flash_bwd_dq": fa.flash_bwd_dq.launches,
                             "flash_bwd_dkv": fa.flash_bwd_dkv.launches})
        return out

    Trainer.train_step, Trainer.evaluate = train_step, evaluate
    try:
        full = run("full", work / "ckpt_full", [])
        cut = run("cut", ckpt_dir, [], stop_after=LIFECYCLE_STOP_AFTER)
        check(cut.get("interrupted", False) and len(cut["losses"]) == LIFECYCLE_STOP_AFTER,
              "the interrupted run was not stopped after epoch 0 step 7")
        latest = max(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
        check(latest == LIFECYCLE_CKPT_EVERY,
              f"the interrupted run's last checkpoint is step {latest}, wanted 5")
        resumed = run("resumed", ckpt_dir, ["--async_checkpointing", "false"])
    finally:
        Trainer.train_step, Trainer.evaluate = orig_step, orig_eval

    # the telemetry's own cost: the train phase's run with telemetry off,
    # then on
    reruns = []
    for i, tel_on in enumerate(RERUN_TELEMETRY):
        tel = work / f"tel_rerun{i}"
        obs.reset(out_dir=str(tel) if tel_on else None)
        fa.flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        try:
            res, tr = cli.run(_train_argv(work, work / f"out_rerun{i}", work / f"model_rerun{i}"))
        finally:
            obs.reset()
        _sync()
        launches = {"flash_fwd": fa.flash_fwd.launches,
                    "flash_bwd_dq": fa.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fa.flash_bwd_dkv.launches}
        n, L = tr.step, BERT_BASE["num_hidden_layers"]
        check(n == CLI_STEPS and launches == {
            "flash_fwd": L * (n + math.ceil(CLI_EVAL_SAMPLES / 4)),
            "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n},
            f"rerun {i}: {n} steps, launches {launches}")
        del tr
        reruns.append({"telemetry": tel_on, "tel": tel if tel_on else None,
                       "samples_per_s": res["train"]["train_samples_per_second_per_chip"],
                       "mfu": res["train"].get("train_mfu", "not measured")})

    # resume: the same losses from step 5 on, bit for bit
    total = LIFECYCLE_EPOCHS * LIFECYCLE_STEPS
    want = torch.stack(full["losses"][LIFECYCLE_CKPT_EVERY:]).float()
    got = torch.stack(resumed["losses"]).float()
    check(len(full["losses"]) == total and got.shape == want.shape,
          f"{len(full['losses'])} uninterrupted and {got.numel()} resumed steps")
    resume_max_abs = float((got - want).abs().max())
    check(torch.equal(got, want), f"the resumed losses differ from the uninterrupted run's "
          f"(max |diff| {resume_max_abs:.3e})")
    check(torch.equal(torch.stack(cut["losses"][:LIFECYCLE_CKPT_EVERY]).float(),
                      torch.stack(full["losses"][:LIFECYCLE_CKPT_EVERY]).float()),
          "the interrupted run's first steps differ from the uninterrupted run's")

    # launches: 12 layers x (train + eval steps) forward, x train steps backward
    L = BERT_BASE["num_hidden_layers"]
    eval_steps = math.ceil(LIFECYCLE_EVAL_SAMPLES / 4)
    for name, r in (("full", full), ("cut", cut), ("resumed", resumed)):
        train_steps, evals = len(r["losses"]), len(r["weights"])
        check(r["launches"]["flash_fwd"] == L * (train_steps + evals * eval_steps),
              f"{name}: flash_fwd launches {r['launches']['flash_fwd']} != {L} x "
              f"({train_steps} + {evals} x {eval_steps})")
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            check(r["launches"][k] == L * train_steps,
                  f"{name}: {k} launches {r['launches'][k]} != {L} x {train_steps}")
    check(len(full["weights"]) == len(resumed["weights"]) == LIFECYCLE_EPOCHS + 1,
          "an eval per epoch and a final eval in the full and resumed runs")

    # the profile names the three bf16 flash kernels
    traces = {name: sorted(r["prof"].glob("train_rank0_*.pt.trace.json"))
              for name, r in (("full", full), ("cut", cut), ("resumed", resumed))}
    check(all(len(t) == 1 for t in traces.values()), f"profile traces: {traces}")
    trace_text = traces["full"][0].read_text()
    named = {k: FLASH_KERNEL_NAMES[(k, "bfloat16")] in trace_text for k in _K1}
    if DEVICE == "cuda":
        check(all(named.values()), f"the profile of train steps 3-6 names {named}")

    # keep-best: the export is the best epoch's weights, with its logits
    trainer = resumed["trainer"]
    cfg = trainer.model.config
    check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
          and trainer.config.max_seq_length == 512 and trainer.config.train_batch_size == 8
          and trainer.config.eval_batch_size == 4, "the CLI did not run at its defaults")
    seq = min(trainer.config.max_seq_length, BERT_BASE["max_position_embeddings"])
    best = trainer.best_epoch
    check(best == full["trainer"].best_epoch == 0,
          f"best epochs {best} and {full['trainer'].best_epoch}, wanted 0 (epoch 1 scripted "
          f"worse)")
    seen = resumed["weights"]      # the weights of epoch 0's, epoch 1's and the final eval
    resume_drift = _weight_drift(seen[0], full["weights"][0])
    check(max(resume_drift.values(), default=0.0) <= RESUME_WEIGHT_TOL,
          f"the resumed run's epoch-0 weights drift from the uninterrupted run's: "
          f"{resume_drift}")
    rerun_drift = _weight_drift(
        load_file(str(work / "model_rerun1" / "model.safetensors")),
        load_file(str(rerun_of / "model.safetensors")))
    check(any(not torch.equal(v, seen[1][k]) for k, v in seen[0].items()),
          "epoch 1 left the weights as epoch 0's: the restore would not be exercised")
    check(all(torch.equal(v, seen[0][k]) for k, v in seen[2].items()),
          "the final eval did not see the best epoch's weights")
    reloaded, _, _ = auto.from_pretrained(str(work / "model_resumed"), dtype=torch.bfloat16,
                                          device=DEVICE, attention_impl="flash")
    for k, v in reloaded.state_dict().items():
        check(torch.equal(v.cpu(), seen[best][k]), f"the export's {k} is not the best epoch's")
    batch = _review_batch(4, seq, DEVICE, split="test")
    with torch.no_grad():
        a = trainer.model.eval()(batch["input_ids"], batch["attention_mask"])
        b = reloaded.eval()(batch["input_ids"], batch["attention_mask"])
    check(torch.equal(a, b), "the reloaded export gives other logits than the best epoch's")
    del reloaded, trainer

    # telemetry: every event and trace valid; the spans and the stalls
    events = {}
    for name, tel in [("full", full["tel"]), ("cut", cut["tel"]), ("resumed", resumed["tel"])] + [
            (f"rerun{i}", r["tel"]) for i, r in enumerate(reruns) if r["telemetry"]]:
        for path in sorted(tel.glob("*.jsonl")):
            n, errors = validate_events_file(str(path), strict_tail=True)
            check(n > 0 and not errors, f"{path.name} of the {name} run: {errors[:3]}")
        n, errors = validate_trace_file(str(tel / "trace.json"))
        check(n > 0 and not errors, f"trace.json of the {name} run: {errors[:3]}")
        events[name] = _events(tel)
    hist = full["results"]["train"]
    split = {n: _step_split(events[n], r["results"]["train"])
             for n, r in (("full", full), ("resumed", resumed))}
    step_dir = max((p for p in ckpt_dir.iterdir() if p.name.isdigit()),
                   key=lambda p: int(p.name))
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    mfu = hist.get("train_mfu")
    if DEVICE == "cuda":
        check(mfu is not None and 0 < mfu < 1, f"train_mfu {mfu}")
    row = {"phase": "train_lifecycle", "card": card,
           "model": "bert-base-uncased widths (random init, seed 42)", "layers": L,
           "dtype": "bfloat16", "seq": seq, "batch": 8, "eval_batch": 4,
           "epochs": LIFECYCLE_EPOCHS, "steps_per_epoch": LIFECYCLE_STEPS,
           "train_steps": {n: len(r["losses"]) for n, r in
                           (("full", full), ("cut", cut), ("resumed", resumed))},
           "launches": {n: r["launches"] for n, r in
                        (("full", full), ("cut", cut), ("resumed", resumed))},
           "resume_from_step": LIFECYCLE_CKPT_EVERY, "resume_bitwise": True,
           "resume_max_abs_diff": resume_max_abs, "resume_weight_drift": resume_drift,
           "rerun_weight_drift": rerun_drift, "best_epoch": best,
           "keep_best_restore_exercised": True, "eval_loss": hist["eval_loss"],
           "eval_loss_scripted": {"epoch": 1, "added": LIFECYCLE_WORSE_EVAL},
           "train_mfu": mfu if mfu is not None else "not measured",
           "train_achieved_tflops_per_chip": hist.get("train_achieved_tflops_per_chip",
                                                      "not measured"),
           "split_async_saves": split["full"], "split_sync_saves": split["resumed"],
           "telemetry_cost": {
               "telemetry": list(RERUN_TELEMETRY),
               "train_samples_per_second_per_chip": [r["samples_per_s"] for r in reruns],
               "train_mfu": [r["mfu"] for r in reruns],
               "on_over_off": (sum(r["samples_per_s"] for r in reruns if r["telemetry"])
                               / sum(r["samples_per_s"] for r in reruns
                                     if not r["telemetry"]))},
           "save_stall_ms_async": [1e3 * s for s in _span_s(events["full"],
                                                           "train/checkpoint")],
           "save_stall_ms_sync": [1e3 * s for s in _span_s(events["resumed"],
                                                          "train/checkpoint")],
           "write_ms_async": [1e3 * s for s in _span_s(events["full"],
                                                      "train/checkpoint_write")],
           "restore_ms": [1e3 * s for s in _span_s(events["resumed"], "train/restore")],
           "checkpoint_bytes": ckpt_bytes,
           "profile_names_kernels": named,
           "events": {n: len(e) for n, e in events.items()},
           "wall_s": {n: r["wall_s"] for n, r in
                      (("full", full), ("cut", cut), ("resumed", resumed))}}
    emit(row)
    return row


# -- the data stack --------------------------------------------------------------

DATA_BUCKET = 64                # --bucket_multiple of run A
DATA_STEPS = 30                 # run A's train steps
DATA_SHORT_STEPS = 20           # runs A' and C
DATA_EVAL_SAMPLES = 64          # run A's 16 eval steps at the eval batch of 4
DATA_PROFILED_STEPS = 6
# the vendored reviews hold 399 distinct words, every one of which a full
# vocab would hold whole; keeping the 300 most frequent leaves the 99 rarest
# to split into characters (real WordPiece continuations)
DATA_VOCAB_WORDS = 300
SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def review_vocab(texts: list, n_words: int = DATA_VOCAB_WORDS) -> list:
    """A ``vocab.txt`` built from ``texts``: BERT's special tokens, the
    ``n_words`` most frequent lowercased (accent-stripped) words, then every
    character alone and as a ``##`` continuation."""
    import collections
    import re

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.wordpiece import (
        _clean_char,
    )

    clean = ["".join(_clean_char(c, True) for c in t) for t in texts]
    counts = collections.Counter(w for t in clean for w in re.findall(r"\w+", t))
    chars = sorted({c for t in clean for c in t if not c.isspace()})
    tokens = SPECIAL_TOKENS + [w for w, _ in counts.most_common(n_words)] + chars + \
        ["##" + c for c in chars]
    return list(dict.fromkeys(tokens))


def _host_cpu() -> str:
    """The host CPU as ``lscpu`` names it (model name, vendor, family and
    model numbers), else ``/proc/cpuinfo``'s model name."""
    import platform

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
        parts = [f"{k.strip()} {fields[k].strip()}" for k in
                 ("Model name", "Vendor ID", "CPU family", "Model") if k in fields]
        if parts:
            return ", ".join(parts)
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine() or "not known"


def _data_argv(tok_dir: Path, work: Path, name: str, steps: int, extra: list) -> list:
    return ["--model_name_or_path", str(tok_dir), "--from_scratch", "true",
            "--dataset", "vendored_reviews", "--epochs", "1", "--steps_per_epoch", str(steps),
            "--max_eval_samples", str(DATA_EVAL_SAMPLES),
            "--output_data_dir", str(work / f"out_{name}"),
            "--model_dir", str(work / f"model_{name}"),
            "--log_every_steps", "10", "--device", DEVICE] + extra


def data_phase(work: Path, card: str) -> dict:
    """The data stack at BERT-base width with the CLI's defaults, on the
    vendored reviews: the host library built from ``csrc/host``; the whole
    corpus (5000 reviews) tokenized by the C++ WordPiece and its Python twin
    over a vocab built from the reviews (ids equal exactly); run A, the CLI
    over that WordPiece directory with ``--bucket_multiple 64`` and the
    autotuned prefetch, 40 steps and 16 eval steps (launches 12 x steps,
    the profile names the three bf16 kernels, finite losses; the widths,
    the pad waste, samples/s, device busy per step, the idle share, MFU,
    the consumer and producer waits and the achieved depth); run A', the
    same with ``HSTD_PREFETCH_AUTOTUNE=0`` for 20 steps, whose losses equal
    A's bit for bit; run C, ``--streaming true`` without bucketing against
    the same run materialized, 20 steps each, losses equal bit for bit."""
    import contextlib
    import math
    import os

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.native import (
        CppWordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        VENDORED_REVIEWS,
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.streaming import (
        StreamingTextDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.wordpiece import (
        WordPieceTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import _build
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    work.mkdir(parents=True, exist_ok=True)
    # the build, timed: from the sources into a directory of its own (the
    # runs below load the library the earlier phases built from the same
    # sources)
    real_dir = _build.HOST_BUILD_DIR
    _build.HOST_BUILD_DIR = work / "host_build"
    try:
        t0 = time.perf_counter()
        lib_path = _build.build_host()
        build_s = time.perf_counter() - t0
    finally:
        _build.HOST_BUILD_DIR = real_dir

    # the whole corpus through both WordPiece cores
    train_texts, train_labels = load_text_classification("vendored_reviews", "train")
    texts = train_texts + load_text_classification("vendored_reviews", "test")[0]
    tokens = review_vocab(texts)
    check(len(tokens) <= BERT_BASE["vocab_size"], f"a vocab of {len(tokens)} tokens")
    vocab = {t: i for i, t in enumerate(tokens)}
    seq = BERT_BASE["max_position_embeddings"]
    t0 = time.perf_counter()
    cpp = CppWordPieceTokenizer(vocab)(texts, max_length=seq)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = WordPieceTokenizer(vocab)(texts, max_length=seq)
    py_s = time.perf_counter() - t0
    for key in py:
        check(np.array_equal(cpp[key], py[key]),
              f"the C++ WordPiece's {key} differ from the Python twin's on the reviews")
    lengths = py["attention_mask"].sum(axis=1)
    tok_dir = work / "wordpiece"
    tok_dir.mkdir(exist_ok=True)
    (tok_dir / "config.json").write_text(json.dumps(BERT_BASE))
    (tok_dir / "vocab.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")

    rec: dict = {}
    orig_step, orig_put, orig_arrays = (Trainer.train_step, pipeline.ShardedBatcher._put_batch,
                                        pipeline.ShardedBatcher.global_arrays)

    def train_step(self, batch):
        out = orig_step(self, batch)
        rec["losses"].append(out["loss"])
        return out

    def put_batch(self, batch):
        if self.drop_remainder:      # the train batcher's batches
            mask = batch["attention_mask"]
            rec["batches"].append((mask.shape[1], int(np.count_nonzero(mask)), mask.size))
        return orig_put(self, batch)

    def global_arrays(self, *a, **kw):
        it = orig_arrays(self, *a, **kw)
        if self.drop_remainder:
            rec["iters"].append(it)
            rec["datasets"].append(type(self.dataset).__name__)
        return it

    def run(name: str, steps: int, extra: list, telemetry: bool = False, env=None) -> dict:
        rec.update(losses=[], batches=[], iters=[], datasets=[])
        tel = work / f"tel_{name}"
        obs.reset(out_dir=str(tel) if telemetry else None)
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        for k in _K1:
            getattr(fa, k).launches = 0
        t0 = time.perf_counter()
        try:
            results, trainer = cli.run(_data_argv(tok_dir, work, name, steps, extra))
        finally:
            obs.reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _sync()
        losses = [float(x) for x in rec["losses"]]
        check(trainer.step == steps and len(losses) == steps,
              f"run {name}: {trainer.step} steps, wanted {steps}")
        check(all(math.isfinite(x) for x in losses), f"run {name}: a non-finite loss")
        return {"results": results, "trainer": trainer, "losses": losses,
                "loss_tensor": torch.stack(rec["losses"]).float().cpu(),
                "batches": list(rec["batches"][:steps]), "iters": list(rec["iters"]),
                "datasets": list(rec["datasets"]), "tel": tel,
                "wall_s": time.perf_counter() - t0,
                "launches": {k: getattr(fa, k).launches for k in _K1}}

    Trainer.train_step = train_step
    pipeline.ShardedBatcher._put_batch = put_batch
    pipeline.ShardedBatcher.global_arrays = global_arrays
    try:
        bucketing = ["--bucket_multiple", str(DATA_BUCKET)]
        a = run("A", DATA_STEPS, bucketing, telemetry=True)
        a2 = run("A_prime", DATA_SHORT_STEPS, bucketing + ["--do_eval", "false"],
                 env={"HSTD_PREFETCH_AUTOTUNE": "0"})
        stream_argv = ["--dataset_path", str(VENDORED_REVIEWS), "--do_eval", "false"]
        c = run("C", DATA_SHORT_STEPS, stream_argv + ["--streaming", "true"])
        c_mat = run("C_materialized", DATA_SHORT_STEPS, stream_argv)
    finally:
        Trainer.train_step = orig_step
        pipeline.ShardedBatcher._put_batch = orig_put
        pipeline.ShardedBatcher.global_arrays = orig_arrays

    L = BERT_BASE["num_hidden_layers"]
    trainer = a["trainer"]
    cfg = trainer.model.config
    check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
          and trainer.config.max_seq_length == 512 and trainer.config.train_batch_size == 8
          and trainer.config.eval_batch_size == 4, "run A did not run at the CLI's defaults")
    check(type(load_tokenizer(str(tok_dir))).__name__ == "CppWordPieceTokenizer",
          "the WordPiece directory did not load the C++ tokenizer")
    eval_steps = math.ceil(DATA_EVAL_SAMPLES / trainer.config.eval_batch_size)
    check(a["launches"]["flash_fwd"] == L * (DATA_STEPS + eval_steps),
          f"run A: flash_fwd launches {a['launches']['flash_fwd']} != {L} x "
          f"({DATA_STEPS} + {eval_steps})")
    for k in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(a["launches"][k] == L * DATA_STEPS,
              f"run A: {k} launches {a['launches'][k]} != {L} x {DATA_STEPS}")
    widths = [w for w, _, _ in a["batches"]]
    check(len(widths) == DATA_STEPS and all(w % DATA_BUCKET == 0 for w in widths),
          f"run A's widths {widths}")
    real = sum(r for _, r, _ in a["batches"])
    padded = sum(p for _, _, p in a["batches"])
    # A': prefetch changes when batches move, not what is computed
    check(torch.equal(a2["loss_tensor"], a["loss_tensor"][:DATA_SHORT_STEPS]),
          "run A' (autotune off) gives other losses than run A")
    check(a2["iters"][0].depth == 2, f"run A' ran at depth {a2['iters'][0].depth}, not 2")
    # C: the stream gives the materialized run's losses
    check(c["datasets"] == [StreamingTextDataset.__name__]
          and c_mat["datasets"] == ["ArrayDataset"], f"run C's datasets {c['datasets']}, "
          f"{c_mat['datasets']}")
    check(torch.equal(c["loss_tensor"], c_mat["loss_tensor"]),
          "run C (streaming) gives other losses than the materialized run")
    exported = load_tokenizer(str(work / "model_A"))
    check(np.array_equal(exported(texts[:64], max_length=seq)["input_ids"],
                         cpp["input_ids"][:64]), "the exported tokenizer gives other ids")

    # device busy and the idle share over more bucketed steps, batches fed
    # by the pipeline: a warm pass, the wall unprofiled, then profiled
    ds = pipeline.ArrayDataset.from_texts(CppWordPieceTokenizer(vocab), train_texts,
                                          train_labels, seq)
    batcher = pipeline.ShardedBatcher(ds, trainer.config.train_batch_size, seed=42,
                                      device=DEVICE,
                                      bucket_sizes=trainer.config.bucket_sizes(seq))

    def steps():
        with contextlib.closing(batcher.global_arrays(0, DATA_STEPS)) as it:
            for _ in range(DATA_PROFILED_STEPS):
                trainer.train_step(next(it))
        _sync()

    steps()
    t1 = time.perf_counter()
    steps()
    steps_wall = time.perf_counter() - t1
    with profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        steps()
    by_kernel = _device_seconds_by_kernel(prof)
    busy = sum(by_kernel.values())
    named = {k: any(FLASH_KERNEL_NAMES[(k, "bfloat16")] in n for n in by_kernel) for k in _K1}
    if DEVICE == "cuda":
        check(all(named.values()), f"the profile of run A's steps names {named}")
    events = _events(a["tel"]) if (a["tel"] / "events.jsonl").exists() else []
    it = a["iters"][0]
    hist = a["results"]["train"]
    row = {"phase": "data", "card": card, "host_cpu": _host_cpu(),
           "host_cpus": os.cpu_count(), "host_library": str(lib_path.name),
           "host_build_s": build_s,
           "vocab_tokens": len(tokens), "vocab_words": DATA_VOCAB_WORDS,
           "corpus_rows": len(texts), "tokenize_cpp_s": cpp_s, "tokenize_python_s": py_s,
           "cpp_equals_python": True,
           "real_tokens_per_row": {"mean": float(lengths.mean()), "min": int(lengths.min()),
                                   "max": int(lengths.max()),
                                   "p50": float(np.percentile(lengths, 50)),
                                   "p90": float(np.percentile(lengths, 90)),
                                   "p99": float(np.percentile(lengths, 99))},
           "run_a": {"steps": DATA_STEPS, "eval_steps": eval_steps, "launches": a["launches"],
                     "bucket_multiple": DATA_BUCKET,
                     "widths_seen": {str(w): widths.count(w) for w in sorted(set(widths))},
                     "real_over_padded": real / padded,
                     "real_over_512": real / (len(widths) * trainer.config.train_batch_size * 512),
                     "loss": a["losses"][-1], "eval_loss": a["results"]["eval"]["eval_loss"],
                     "train_samples_per_second_per_chip":
                         hist["train_samples_per_second_per_chip"],
                     "train_mfu": hist.get("train_mfu", "not measured"),
                     "train_achieved_tflops_per_chip":
                         hist.get("train_achieved_tflops_per_chip", "not measured"),
                     "consumer_wait_s": it.stats.consumer_wait,
                     "producer_wait_s": it.stats.producer_wait,
                     "achieved_depth": it.depth,
                     "autotune_decisions": sum(e["type"] == "autotune" for e in events),
                     "profiled_steps": DATA_PROFILED_STEPS,
                     "step_time_unprofiled_ms": 1e3 * steps_wall / DATA_PROFILED_STEPS,
                     "device_busy_ms_per_step": (1e3 * busy / DATA_PROFILED_STEPS
                                                 if busy else "not measured"),
                     "idle_share": 1.0 - busy / steps_wall if busy else "not measured",
                     "profile_names_kernels": named, "wall_s": a["wall_s"],
                     "top_kernels_ms_per_step": [
                         [k[:80], 1e3 * v / DATA_PROFILED_STEPS] for k, v in
                         sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]]},
           "run_a_prime": {"steps": DATA_SHORT_STEPS, "autotune": False,
                           "depth": a2["iters"][0].depth, "losses_equal_run_a": True,
                           "train_samples_per_second_per_chip":
                               a2["results"]["train"]["train_samples_per_second_per_chip"],
                           "consumer_wait_s": a2["iters"][0].stats.consumer_wait,
                           "producer_wait_s": a2["iters"][0].stats.producer_wait},
           "run_c": {"steps": DATA_SHORT_STEPS, "losses_equal_materialized": True,
                     "streaming_samples_per_second_per_chip":
                         c["results"]["train"]["train_samples_per_second_per_chip"],
                     "materialized_samples_per_second_per_chip":
                         c_mat["results"]["train"]["train_samples_per_second_per_chip"],
                     "streaming_consumer_wait_s": c["iters"][0].stats.consumer_wait,
                     "streaming_producer_wait_s": c["iters"][0].stats.producer_wait}}
    emit(row)
    del trainer, a, a2, c, c_mat
    return row


# -- the encoder families and their tasks -------------------------------------

ENCODER_EVAL_SAMPLES = 64       # 16 eval steps at the eval batch of 4
QA_EVAL_SAMPLES = 64            # --eval_qa_samples: answers decoded over their windows
QA_WINDOWED_DEPTH = 2
EVAL_TASK_KEYS = {"seq-cls": [], "token-cls": ["eval_f1"],
                  "qa": ["eval_exact_match", "eval_f1"]}
ENCODER_PROFILED_STEPS = 6


def _encoder_runs() -> list:
    """The runs of the ``encoder_tasks`` phase: (name, family, published
    config, task, train steps, max_seq_length, extra CLI arguments), each
    at the CLI's other defaults (bf16, batch 8, eval batch 4, AdamW)."""
    qa = ["--dataset", "synthetic", "--eval_qa_samples", str(QA_EVAL_SAMPLES)]
    reviews = ["--dataset", "vendored_reviews"]
    return [
        ("qa_bert_large", "bert", BERT_LARGE, "qa", 30, 384,
         qa + ["--qa_doc_stride", "128"]),
        ("qa_windowed", "bert", dict(BERT_LARGE, num_hidden_layers=QA_WINDOWED_DEPTH), "qa",
         10, 64, qa + ["--qa_doc_stride", "32"]),
        ("token_cls_roberta", "roberta", ROBERTA_BASE, "token-cls", 30, 128,
         ["--dataset", "synthetic", "--num_labels", "9"]),
        ("seq_cls_distilbert", "distilbert", DISTILBERT_BASE, "seq-cls", 30, 512, reviews),
        ("seq_cls_electra", "electra", ELECTRA_SMALL, "seq-cls", 15, 512, reviews),
        ("seq_cls_albert", "albert", ALBERT_BASE, "seq-cls", 15, 512, reviews),
    ]


def _head_out(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _encoder_run(work: Path, spec, peak) -> tuple:
    """One run of the training CLI, counted: the launches (K1 in every
    layer of every train, eval and QA-eval forward), the results files'
    keys, finite losses, the export reloaded to the same eval logits."""
    import math
    import os

    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import load_qa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    name, family, hf, task, steps, seq, extra = spec
    cfg_dir, out_dir, model_dir = work / name / "config", work / name / "out", work / name / "model"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.json").write_text(json.dumps(hf))
    argv = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true", "--task", task,
            "--epochs", "1", "--steps_per_epoch", str(steps), "--max_seq_length", str(seq),
            "--max_eval_samples", str(ENCODER_EVAL_SAMPLES), "--output_data_dir", str(out_dir),
            "--model_dir", str(model_dir), "--log_every_steps", "10", "--device", DEVICE] + extra
    # the meter counts real tokens (MFU) when a peak is named; the table's
    # peak for this card, so no telemetry files are written
    saved = os.environ.get("HSTD_PEAK_TFLOPS")
    if peak:
        os.environ["HSTD_PEAK_TFLOPS"] = str(peak)
    for k in _K1:
        getattr(fa, k).launches = 0
    t0 = time.perf_counter()
    try:
        results, trainer = cli.run(argv)
        _sync()
    finally:
        if saved is None:
            os.environ.pop("HSTD_PEAK_TFLOPS", None)
        else:
            os.environ["HSTD_PEAK_TFLOPS"] = saved
    wall = time.perf_counter() - t0
    launches = {k: getattr(fa, k).launches for k in _K1}
    tc, cfg = trainer.config, trainer.model.config
    max_len = min(seq, cfg.max_position_embeddings)
    tokenizer = load_tokenizer(str(cfg_dir), vocab_size=cfg.vocab_size)
    eval_ds = cli.build_dataset(tc, tokenizer, "test", max_len, tc.max_eval_samples, cfg)
    eval_steps = math.ceil(len(eval_ds) / tc.eval_batch_size)
    qa_windows = qa_batches = 0
    if task == "qa":
        q, c, s_, a = load_qa(tc.dataset, "test", max_samples=tc.eval_qa_samples, seed=tc.seed)
        qa_windows = len(tokenizer.encode_qa(q, c, s_, a, max_length=max_len,
                                             doc_stride=tc.qa_doc_stride)["input_ids"])
        qa_batches = math.ceil(qa_windows / tc.eval_batch_size)
    L = cfg.num_layers
    train_steps = trainer.step
    check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
          and tc.train_batch_size == 8 and tc.eval_batch_size == 4,
          f"{name}: the CLI did not run at its defaults")
    check(train_steps == steps, f"{name}: {train_steps} train steps, wanted {steps}")
    want = {"flash_fwd": L * (train_steps + eval_steps + qa_batches),
            "flash_bwd_dq": L * train_steps, "flash_bwd_dkv": L * train_steps}
    check(launches == want, f"{name}: launches {launches}, wanted {want} ({L} layers x "
          f"({train_steps} train + {eval_steps} eval + {qa_batches} QA-eval steps))")
    hist, ev = results["train"], results["eval"]
    check(all(math.isfinite(x) for x in hist["loss"])
          and all(math.isfinite(v) for v in ev.values()), f"{name}: a non-finite result")
    tr = read_results_file(str(out_dir / "train_results.txt"))
    er = read_results_file(str(out_dir / "eval_results.txt"))
    mfu_keys = ["train_achieved_tflops_per_chip", "train_mfu"] if peak else []
    check(list(tr) == TRAIN_RESULT_KEYS + mfu_keys, f"{name}: train_results.txt keys {list(tr)}")
    check(list(er) == EVAL_RESULT_KEYS + EVAL_TASK_KEYS[task],
          f"{name}: eval_results.txt keys {list(er)}")

    # the export reloads through from_pretrained to the same eval logits
    rows = eval_ds[np.arange(4)]
    batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=DEVICE)
             for k, v in rows.items() if k in ("input_ids", "attention_mask", "token_type_ids")}
    reloaded, fam, _ = auto.from_pretrained(str(model_dir), task=task,
                                            num_labels=tc.num_labels, dtype=torch.bfloat16,
                                            device=DEVICE, attention_impl="flash")
    model = trainer.model.eval()
    with torch.no_grad():
        a_ = _head_out(model(**batch))
        b_ = _head_out(reloaded(**batch))
    check(fam == family and all(torch.equal(x, y) for x, y in zip(a_, b_)),
          f"{name}: the reloaded export gives other logits")
    del reloaded, a_, b_
    row = {"phase": "encoder_tasks", "run": name, "family": family, "task": task,
           "hidden": cfg.hidden_size, "layers": L, "heads": cfg.num_heads,
           "embedding_size": cfg.embedding_size, "vocab": cfg.vocab_size, "seq": max_len,
           "batch": tc.train_batch_size, "dtype": "bfloat16", "dataset": tc.dataset,
           "train_steps": train_steps, "eval_steps": eval_steps, "eval_rows": len(eval_ds),
           "qa_eval_examples": tc.eval_qa_samples if task == "qa" else None,
           "qa_eval_windows": qa_windows if task == "qa" else None,
           "launches": launches, "loss": hist["loss"], "eval": ev,
           "train_samples_per_second_per_chip": hist["train_samples_per_second_per_chip"],
           "step_time_s": trainer.meter.avg_step_time,
           "train_mfu": hist.get("train_mfu", "not measured"),
           "train_achieved_tflops_per_chip": hist.get("train_achieved_tflops_per_chip",
                                                      "not measured"),
           "cli_wall_s": wall}
    return row, trainer, batch


def encoder_tasks_phase(work: Path, card: str) -> dict:
    """(e) the encoder families through the training CLI at their
    published widths, random weights from seed 42, bf16 through the flash
    kernels: BERT-large QA (sequence 384, doc stride 128, answers decoded
    over their windows: EM/F1; then ``ENCODER_PROFILED_STEPS`` more train
    steps timed unprofiled and profiled: device busy, the idle share, the
    three bf16 kernels named); BERT-large widths at depth 2 on sequence 64
    with stride 32, so that contexts split into windows; RoBERTa-base
    token-cls (synthetic NER, 9 labels, sequence 128); DistilBERT-base,
    ELECTRA-small and ALBERT-base-v2 seq-cls on the reviews at 512. Each
    run's K1 launches equal its count per step (ALBERT: 12 uses of its one
    layer), and each export reloads to the same eval logits. Returns the
    rows by run."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops

    work.mkdir(parents=True, exist_ok=True)
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    rows = {}
    for spec in _encoder_runs():
        row, trainer, batch = _encoder_run(work, spec, peak)
        name, task = spec[0], spec[3]
        if task == "qa":
            check(row["qa_eval_windows"] >= row["qa_eval_examples"],
                  f"{name}: {row['qa_eval_windows']} windows")
        if name == "qa_windowed":
            # contexts of 30-80 words in rows of 64: most split into windows
            check(row["qa_eval_windows"] > row["qa_eval_examples"],
                  f"{name}: no context split into windows")
        if name == "qa_bert_large":
            row.update(_encoder_idle(trainer, spec))
        row["card"] = card
        emit(row)
        rows[name] = row
        del trainer, batch
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return rows


def _steps_profile(trainer, batch, steps: int, flops_per_step: float | None = None,
                   peak=None) -> dict:
    """``steps`` more train steps on one batch (:func:`_timed_then_profiled`):
    the wall per step unprofiled, device busy per step, the idle share, each
    kernel's device seconds (``by_kernel_s``, for the caller's own kernel
    sums) and the top kernels; with the model's ``flops_per_step`` the
    achieved TFLOP/s over the unprofiled wall and MFU against ``peak``."""
    wall, by_kernel = _timed_then_profiled(trainer, [batch] * steps)
    busy = sum(by_kernel.values())
    row = {"profiled_steps": steps, "step_time_unprofiled_ms": 1e3 * wall / steps,
           "device_busy_ms_per_step": 1e3 * busy / steps if busy else "not measured",
           "idle_share": 1.0 - busy / wall if busy else "not measured",
           "by_kernel_s": by_kernel,
           "top_kernels_ms_per_step": [[k[:80], 1e3 * v / steps] for k, v in
                                       sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]]}
    if flops_per_step is not None:
        achieved = flops_per_step * steps / wall / 1e12
        row.update(achieved_tflops=achieved,
                   mfu=achieved / peak if peak else "not measured")
    return row


def _kernel_ms_per_step(prof: dict, names: dict) -> dict:
    """Device ms per profiled step of each wrapper of ``names`` (wrapper ->
    the kernel name the profile holds, or a tuple of names summed), from
    :func:`_steps_profile`."""
    return {k: sum(v for n, v in prof["by_kernel_s"].items()
                   if any(x in n for x in ((name,) if isinstance(name, str) else name)))
            / prof["profiled_steps"] * 1e3 for k, name in names.items()}


def _encoder_idle(trainer, spec) -> dict:
    """``ENCODER_PROFILED_STEPS`` more train steps on one training batch
    (:func:`_steps_profile`); the profile must name the three bf16 flash
    kernels."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    name, seq = spec[0], spec[5]
    tc, cfg = trainer.config, trainer.model.config
    tokenizer = load_tokenizer(tc.model_name_or_path, vocab_size=cfg.vocab_size)
    ds = cli.build_dataset(tc, tokenizer, "train", seq, 8, cfg)
    b = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=DEVICE)
         for k, v in ds[np.arange(8)].items()}
    prof = _steps_profile(trainer, b, ENCODER_PROFILED_STEPS)
    flash = _kernel_ms_per_step(prof, {k: FLASH_KERNEL_NAMES[(k, "bfloat16")] for k in _K1})
    busy = sum(prof.pop("by_kernel_s").values())
    if DEVICE == "cuda":
        for k, ms in flash.items():
            check(ms > 0, f"{name}: no {FLASH_KERNEL_NAMES[(k, 'bfloat16')]} in the profile")
    return {**prof, "flash_ms_per_step": flash,
            "flash_share_of_busy": (sum(flash.values()) * ENCODER_PROFILED_STEPS / 1e3 / busy
                                    if busy else "not measured")}


# -- masked-LM and replaced-token-detection pretraining ----------------------

MLM_STEPS = 20                  # runs 1 and 2
MLM_EVAL_SAMPLES = 64           # 16 eval steps at the eval batch of 4
MLM_LARGE_STEPS = 10
RTD_STEPS = 15
MLM_STREAM_STEPS = 10
MLM_PROFILED_STEPS = 6
MLM_LARGE_PROFILED_STEPS = 3


def _mlm_runs() -> list:
    """The runs of the ``mlm`` phase: (name, family, published config,
    task, train steps, extra CLI arguments), each at the CLI's other
    defaults (bf16, sequence 512, batch 8, eval batch 4, AdamW)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        VENDORED_REVIEWS,
    )

    fused = ["--fused_vocab_ce", "true"]
    evals = ["--max_eval_samples", str(MLM_EVAL_SAMPLES)]
    no_eval = ["--do_eval", "false"]
    return [
        ("bert_base_fused", "bert", BERT_BASE, "mlm", MLM_STEPS, fused + evals),
        ("bert_base_unfused", "bert", BERT_BASE, "mlm", MLM_STEPS,
         ["--fused_vocab_ce", "false"] + evals),
        ("bert_large_fused", "bert", BERT_LARGE, "mlm", MLM_LARGE_STEPS, fused + no_eval),
        ("electra_small_rtd", "electra", ELECTRA_SMALL, "rtd", RTD_STEPS, evals),
        ("bert_base_streaming", "bert", BERT_BASE, "mlm", MLM_STREAM_STEPS,
         fused + no_eval + ["--streaming", "true", "--dataset_path", str(VENDORED_REVIEWS)]),
    ]


def mlm_phase(work: Path, card: str) -> dict:
    """(f) masked-LM and replaced-token-detection pretraining through the
    training CLI, random weights, bf16, the CLI's defaults, on the reviews
    tokenized by a WordPiece ``vocab.txt`` built from them
    (``review_vocab``: the rarest words split into ``##`` pieces, so
    whole-word masking masks multi-piece words): (1) BERT-base widths,
    ``--task mlm --fused_vocab_ce true``, 30 steps and 16 eval steps: K1
    and K2 in one step, launches ``flash_fwd == 12 x (train + eval)``,
    ``flash_bwd_* == 12 x train``, ``fused_ce_fwd == train + eval``,
    ``fused_ce_bwd_* == train``; masked tokens a batch, K and the fused
    loss's own ``ce_dropped`` summed over the train steps (it must equal
    the masked tokens past K, and be 0 here); 6 more steps timed and
    profiled (busy, idle, MFU, top kernels, the K1 and K2 kernels named); (2) the same run with
    ``--fused_vocab_ce false`` (the unfused [8, 512, 30522] fp32 logits),
    profiled the same way, its first loss within the bf16 gate of run 1's;
    (3) BERT-large-WWM widths, fused, 10 steps, profiled: dW at H 1032 on
    ``vocab_ce_bwd_dw_kernel``; (4) ELECTRA-small ``--task rtd``, 15
    steps, detection accuracy; (5) streaming ``--task mlm``, 10 steps,
    finite losses. Each export reloads through ``from_pretrained`` to the
    same logits bit for bit. Each row carries its run's wall seconds, the
    summary the phase's. Returns the rows by run."""
    import math
    import os

    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        Trainer,
        bias_fold_width,
        mlm_gather_rows,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    phase_t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    texts = (load_text_classification("vendored_reviews", "train")[0]
             + load_text_classification("vendored_reviews", "test")[0])
    tokens = review_vocab(texts)
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    counters = [(fa, k) for k in _K1] + [(vc, k) for k in _K2]
    rec: dict = {}
    orig_step = Trainer.train_step

    def train_step(self, batch):
        loss_fn = self.loss_fn

        def recorded(model, batch_):        # the fused loss's own ce_dropped
            loss, sums = loss_fn(model, batch_)
            if "ce_dropped" in sums:
                rec["ce_dropped"].append(sums["ce_dropped"].detach())
            return loss, sums

        self.loss_fn = recorded
        try:
            out = orig_step(self, batch)
        finally:
            self.loss_fn = loss_fn
        rec["losses"].append(out["loss"])
        rec["masked"].append(((batch["labels"] != -100) & (batch["attention_mask"] > 0)).sum())
        return out

    rows: dict = {}
    Trainer.train_step = train_step
    saved_peak = os.environ.get("HSTD_PEAK_TFLOPS")
    if peak:
        os.environ["HSTD_PEAK_TFLOPS"] = str(peak)
    try:
        for name, family, hf, task, steps, extra in _mlm_runs():
            run_dir = work / name
            cfg_dir = run_dir / "config"
            cfg_dir.mkdir(parents=True, exist_ok=True)
            (cfg_dir / "config.json").write_text(json.dumps(hf))
            (cfg_dir / "vocab.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
            argv = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
                    "--task", task, "--dataset", "vendored_reviews", "--epochs", "1",
                    "--steps_per_epoch", str(steps), "--output_data_dir", str(run_dir / "out"),
                    "--model_dir", str(run_dir / "model"), "--log_every_steps", "10",
                    "--device", DEVICE] + extra
            rec.update(losses=[], masked=[], ce_dropped=[])
            for mod, k in counters:
                getattr(mod, k).launches = 0
            t0 = time.perf_counter()
            results, trainer = cli.run(argv)
            _sync()
            wall = time.perf_counter() - t0
            launches = {k: getattr(mod, k).launches for mod, k in counters}
            tc, cfg = trainer.config, trainer.model.config
            L, train_steps = cfg.num_layers, trainer.step
            losses = [float(x) for x in rec["losses"]]
            masked = [int(x) for x in rec["masked"]]
            dropped = [float(x) for x in rec["ce_dropped"]]
            check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
                  and tc.max_seq_length == 512 and tc.train_batch_size == 8
                  and tc.eval_batch_size == 4, f"{name}: the CLI did not run at its defaults")
            check(train_steps == steps and len(losses) == steps,
                  f"{name}: {train_steps} train steps, wanted {steps}")
            check(all(math.isfinite(x) for x in losses), f"{name}: a non-finite loss")
            eval_steps = math.ceil(MLM_EVAL_SAMPLES / tc.eval_batch_size) if tc.do_eval else 0
            fused = task == "mlm" and tc.fused_vocab_ce
            check(len(dropped) == (steps if fused else 0),
                  f"{name}: ce_dropped read on {len(dropped)} of {steps} train steps")
            want = {"flash_fwd": L * (train_steps + eval_steps),
                    "flash_bwd_dq": L * train_steps, "flash_bwd_dkv": L * train_steps,
                    "fused_ce_fwd": (train_steps + eval_steps) if fused else 0,
                    "fused_ce_bwd_dh": train_steps if fused else 0,
                    "fused_ce_bwd_dw": train_steps if fused else 0}
            check(launches == want, f"{name}: launches {launches}, wanted {want}")
            hist, ev = results["train"], results.get("eval", {})
            check(all(math.isfinite(v) for v in ev.values()), f"{name}: a non-finite eval")
            if tc.do_eval:
                er = read_results_file(str(run_dir / "out" / "eval_results.txt"))
                check(list(er) == EVAL_RESULT_KEYS, f"{name}: eval_results.txt keys {list(er)}")
            seq = min(tc.max_seq_length, cfg.max_position_embeddings)
            n_tok = tc.train_batch_size * seq
            k_rows = mlm_gather_rows(n_tok, tc.fused_mlm_mask_cap) if task == "mlm" else None
            row = {"phase": "mlm", "run": name, "card": card, "family": family, "task": task,
                   "hidden": cfg.hidden_size, "layers": L, "heads": cfg.num_heads,
                   "vocab": cfg.vocab_size, "wordpiece_tokens": len(tokens), "seq": seq,
                   "batch": tc.train_batch_size, "dtype": "bfloat16",
                   "fused_vocab_ce": bool(tc.fused_vocab_ce), "streaming": bool(tc.streaming),
                   "train_steps": train_steps, "eval_steps": eval_steps,
                   "launches": launches, "first_loss": losses[0], "loss": losses[-1],
                   "eval": ev,
                   "train_samples_per_second_per_chip":
                       hist["train_samples_per_second_per_chip"],
                   "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                   "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall}
            if task == "mlm":
                row.update(masked_tokens_per_batch={"mean": float(np.mean(masked)),
                                                    "min": min(masked), "max": max(masked)},
                           gather_rows_k=k_rows, mask_cap=tc.fused_mlm_mask_cap,
                           ce_dropped_train=sum(dropped) if fused else "not fused",
                           ce_dropped_wanted=sum(max(0, m - k_rows) for m in masked),
                           bias_fold_width=bias_fold_width(cfg.embedding_size
                                                           or cfg.hidden_size))
            # the export reloads through from_pretrained to the same logits
            tokenizer = load_tokenizer(str(cfg_dir), vocab_size=cfg.vocab_size)
            ds = cli.build_dataset(tc, tokenizer, "train", seq, 8, cfg)
            batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=DEVICE)
                     for k, v in ds[np.arange(8)].items()}
            reloaded, fam, _ = auto.from_pretrained(
                str(run_dir / "model"), task=task, dtype=torch.bfloat16, device=DEVICE,
                attention_impl="flash")
            with torch.no_grad():
                a_ = trainer.model.eval()(batch["input_ids"][:4], batch["attention_mask"][:4])
                b_ = reloaded.eval()(batch["input_ids"][:4], batch["attention_mask"][:4])
            check(fam == family and torch.equal(a_, b_),
                  f"{name}: the reloaded export gives other logits")
            row["export_reloads_bit_for_bit"] = True
            del reloaded, a_, b_
            if name in ("bert_base_fused", "bert_base_unfused", "bert_large_fused"):
                n_steps = MLM_LARGE_PROFILED_STEPS if "large" in name else MLM_PROFILED_STEPS
                # MFU: the model's FLOPs per real token (obs.flops)
                fpt = flops.train_flops_per_token(cfg, task, batch["input_ids"].shape[1])
                prof = _steps_profile(trainer, batch, n_steps,
                                      fpt * int(batch["attention_mask"].sum()), peak)
                k2 = _kernel_ms_per_step(prof, {k: vocab_step_names(k, "bfloat16")
                                                for k in _K2})
                k1 = _kernel_ms_per_step(prof, {k: FLASH_KERNEL_NAMES[(k, "bfloat16")]
                                                for k in _K1})
                prof.pop("by_kernel_s")
                prof["k1_ms_per_step"], prof["k2_ms_per_step"] = k1, k2
                prof["k2_routes"] = {k: vocab_kernel_names(k, "bfloat16")[0] for k in _K2}
                if DEVICE == "cuda":
                    check(all(v > 0 for v in k1.values()),
                          f"{name}: the profile misses a K1 kernel: {k1}")
                    if fused:
                        check(all(v > 0 for v in k2.values()),
                              f"{name}: the profile misses a K2 kernel: {k2}")
                row.update(prof)
            row["run_wall_s"] = time.perf_counter() - t0    # the CLI, reload and profile
            rows[name] = row
            emit(row)
            del trainer
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    finally:
        Trainer.train_step = orig_step
        if saved_peak is None:
            os.environ.pop("HSTD_PEAK_TFLOPS", None)
        else:
            os.environ["HSTD_PEAK_TFLOPS"] = saved_peak
    base, unfused = rows["bert_base_fused"], rows["bert_base_unfused"]
    first_rel = abs(base["first_loss"] - unfused["first_loss"]) / abs(unfused["first_loss"])
    check(first_rel <= PARITY_BF16_LOSS_RTOL,
          f"the fused and unfused MLM runs' first losses differ by {first_rel} (relative)")
    for r in rows.values():
        if r["task"] == "mlm" and r["fused_vocab_ce"]:
            check(r["ce_dropped_train"] == r["ce_dropped_wanted"],
                  f"{r['run']}: the loss dropped {r['ce_dropped_train']} masked tokens, "
                  f"{r['ce_dropped_wanted']} lie past K")
    check(base["ce_dropped_train"] == 0, f"ce_dropped {base['ce_dropped_train']} at 15%")
    summary = {"phase": "mlm_summary", "card": card,
               "phase_wall_s": time.perf_counter() - phase_t0,
               "run_wall_s": {n: r["run_wall_s"] for n, r in rows.items()},
               "first_loss_fused_over_unfused_rel": first_rel,
               "first_loss_rtol": PARITY_BF16_LOSS_RTOL,
               "samples_per_s": {n: r["train_samples_per_second_per_chip"]
                                 for n, r in rows.items()},
               "busy_ms_per_step": {n: r.get("device_busy_ms_per_step")
                                    for n, r in rows.items() if "profiled_steps" in r},
               "fused_over_unfused_step_time": (base["step_time_unprofiled_ms"]
                                                / unfused["step_time_unprofiled_ms"]),
               "bert_large_dw_ms_per_step": rows["bert_large_fused"]["k2_ms_per_step"][
                   "fused_ce_bwd_dw"],
               "electra_rtd_detection_accuracy": rows["electra_small_rtd"]["eval"].get(
                   "eval_accuracy")}
    emit(summary)
    return rows


# -- encoder-decoder seq2seq ----------------------------------------------------

S2S_STEPS = 20                  # runs 1 and 2
S2S_EVAL_SAMPLES = 64           # 16 eval steps at the eval batch of 4
S2S_ROUGE_SAMPLES = 32
S2S_SHORT_STEPS = 10            # span corruption, streaming
S2S_SHORT_EVAL_SAMPLES = 16     # span corruption's 4 eval steps
BART_STEPS = 15
BART_ROUGE_SAMPLES = 16
S2S_PROFILED_STEPS = 6
BART_PROFILED_STEPS = 3
GEN_ROWS = 8                    # the generation check's source rows


def _seq2seq_runs() -> list:
    """The runs of the ``seq2seq`` phase: (name, family, published config,
    train steps, eval samples, extra CLI arguments), each at the CLI's
    other defaults (bf16, sequence 512, target 64, batch 8, eval batch 4)
    with label smoothing 0.1 on the synthetic summarization corpus."""
    fused = ["--fused_vocab_ce", "true"]
    t5 = ["--optimizer", "adafactor", "--learning_rate", "1e-3", "--weight_decay", "0"]
    return [
        ("t5_small_fused", "t5", T5_SMALL, S2S_STEPS, S2S_EVAL_SAMPLES,
         t5 + fused + ["--eval_rouge_samples", str(S2S_ROUGE_SAMPLES)]),
        ("t5_small_unfused", "t5", T5_SMALL, S2S_STEPS, 0,
         t5 + ["--fused_vocab_ce", "false"]),
        ("t5_small_span", "t5", T5_SMALL, S2S_SHORT_STEPS, S2S_SHORT_EVAL_SAMPLES,
         t5 + fused + ["--span_corruption", "true"]),
        ("t5_small_streaming", "t5", T5_SMALL, S2S_SHORT_STEPS, 0,
         t5 + fused + ["--streaming", "true"]),
        ("bart_base_fused", "bart", BART_BASE, BART_STEPS, S2S_EVAL_SAMPLES,
         fused + ["--eval_rouge_samples", str(BART_ROUGE_SAMPLES)]),
    ]


def _generation_check(model_dir: Path, eval_ds, tc) -> dict:
    """Greedy ``generate`` on the fp32 reload of an export (TF32 off)
    over ``GEN_ROWS`` eval sources, all ``S2S_TARGET`` new tokens (EOS
    switched off: a model a few steps from random weights emits it
    first): decode tokens/s, and the tokens equal to the argmax of a
    teacher-forced decode of the model's own output up to the first step
    whose top-two logit gap is below ``NEAR_TIE`` (a near-tie, counted)."""
    import dataclasses

    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate,
    )

    model, _, cfg = auto.from_pretrained(str(model_dir), task="seq2seq",
                                         dtype=torch.float32, device=DEVICE)
    model.config = cfg = dataclasses.replace(cfg, eos_token_id=-1)
    cols = eval_ds[np.arange(GEN_ROWS)]
    ids = torch.as_tensor(np.asarray(cols["input_ids"]), device=DEVICE).long()
    mask = torch.as_tensor(np.asarray(cols["attention_mask"]), device=DEVICE).long()
    generate(model, ids[:1], mask[:1], max_new_tokens=2)            # warm the allocator
    _sync()
    t0 = time.perf_counter()
    out = generate(model, ids, mask, max_new_tokens=tc.max_target_length)
    _sync()
    wall = time.perf_counter() - t0
    start = torch.full((GEN_ROWS, 1), cfg.decoder_start_token_id, device=DEVICE)
    with torch.no_grad():
        logits = model(ids, mask, torch.cat([start, out[:, :-1].long()], 1))
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).tolist()
    ref = logits.argmax(-1).tolist()
    compared = near_ties = 0
    for r, row in enumerate(out.tolist()):
        n = next((i for i, gp in enumerate(gaps[r]) if gp < NEAR_TIE), len(row))
        near_ties += n < len(row)
        check(row[:n] == ref[r][:n], f"generation row {r}: cached greedy tokens {row[:n]} "
              f"differ from the teacher-forced argmax {ref[r][:n]} before any near-tie")
        compared += n
    check(compared >= GEN_ROWS, f"generation compared only {compared} tokens")
    del model
    return {"rows": GEN_ROWS, "max_new_tokens": tc.max_target_length, "dtype": "float32",
            "distinct_tokens": len(set(out.flatten().tolist())),
            "tokens_compared": compared, "near_ties": near_ties, "generate_wall_s": wall,
            "decode_tokens_per_s": out.numel() / wall}


def seq2seq_phase(work: Path, card: str) -> dict:
    """(g) encoder-decoder seq2seq through the training CLI at published
    widths, random weights, bf16, on the synthetic CNN/DailyMail-shaped
    corpus (``_seq2seq_runs``): T5-small fused under Adafactor (30 steps,
    16 eval steps, ROUGE-L of 32 greedy summaries), the same unfused, span
    corruption (the target length raised to 106), streaming, BART-base
    fused under AdamW. Each fused run's launches are ``fused_ce_fwd ==
    train + eval steps`` and ``fused_ce_bwd_* == train steps``, K1 none (T5
    and BART run the plain attention); losses are finite; each export
    reloads through ``from_pretrained`` to the same logits bit for bit;
    T5 fused and unfused and BART take more steps timed and profiled
    (busy, idle, MFU over encoder and decoder tokens, K2's ms and share);
    the first run's export is held by :func:`_generation_check`. Each row
    carries its run's wall seconds, the summary the phase's. Returns the
    rows by run."""
    import os

    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    phase_t0 = time.perf_counter()
    work.mkdir(parents=True, exist_ok=True)
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    counters = [(fa, k) for k in _K1] + [(vc, k) for k in _K2]
    rec: dict = {}
    orig_step = Trainer.train_step

    def train_step(self, batch):
        out = orig_step(self, batch)
        rec["losses"].append(out["loss"])
        rec["targets"].add(int(batch["labels"].shape[1]))
        return out

    rows: dict = {}
    Trainer.train_step = train_step
    saved_peak = os.environ.get("HSTD_PEAK_TFLOPS")
    if peak:
        os.environ["HSTD_PEAK_TFLOPS"] = str(peak)
    try:
        for name, family, hf, steps, eval_samples, extra in _seq2seq_runs():
            run_dir = work / name
            cfg_dir = run_dir / "config"
            cfg_dir.mkdir(parents=True, exist_ok=True)
            (cfg_dir / "config.json").write_text(json.dumps(hf))
            evals = (["--max_eval_samples", str(eval_samples)] if eval_samples
                     else ["--do_eval", "false"])
            argv = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
                    "--task", "seq2seq", "--dataset", "synthetic", "--label_smoothing", "0.1",
                    "--epochs", "1", "--steps_per_epoch", str(steps),
                    "--max_train_samples", str(8 * steps),
                    "--output_data_dir", str(run_dir / "out"),
                    "--model_dir", str(run_dir / "model"), "--log_every_steps", "10",
                    "--device", DEVICE] + evals + extra
            rec.update(losses=[], targets=set())
            for mod, k in counters:
                getattr(mod, k).launches = 0
            t0 = time.perf_counter()
            results, trainer = cli.run(argv)
            _sync()
            wall = time.perf_counter() - t0
            launches = {k: getattr(mod, k).launches for mod, k in counters}
            tc, cfg = trainer.config, trainer.model.config
            losses = [float(x) for x in rec["losses"]]
            check(cfg.dtype == torch.bfloat16 and tc.max_seq_length == S2S_SEQ
                  and tc.max_target_length == S2S_TARGET and tc.train_batch_size == 8
                  and tc.eval_batch_size == 4, f"{name}: the CLI did not run at its defaults")
            check(trainer.step == steps and len(losses) == steps,
                  f"{name}: {trainer.step} train steps, wanted {steps}")
            check(all(math.isfinite(x) for x in losses), f"{name}: a non-finite loss")
            target = int(S2S_SEQ * 0.2) + 4 if tc.span_corruption else S2S_TARGET
            check(rec["targets"] == {target}, f"{name}: targets {rec['targets']}, "
                  f"wanted {target}")
            eval_steps = math.ceil(eval_samples / tc.eval_batch_size)
            fused = bool(tc.fused_vocab_ce)
            want = {**{k: 0 for k in _K1},
                    "fused_ce_fwd": steps + eval_steps if fused else 0,
                    "fused_ce_bwd_dh": steps if fused else 0,
                    "fused_ce_bwd_dw": steps if fused else 0}
            check(launches == want, f"{name}: launches {launches}, wanted {want}")
            hist, ev = results["train"], results.get("eval", {})
            check(all(math.isfinite(v) for v in ev.values()), f"{name}: a non-finite eval")
            if tc.do_eval:
                er = read_results_file(str(run_dir / "out" / "eval_results.txt"))
                keys = EVAL_RESULT_KEYS + (["rougeL_precision", "rougeL_recall", "rougeL_f1"]
                                           if tc.eval_rouge_samples else [])
                check(list(er) == keys, f"{name}: eval_results.txt keys {list(er)}")
            row = {"phase": "seq2seq", "run": name, "card": card, "family": family,
                   "d_model": cfg.d_model, "vocab": cfg.vocab_size, "seq": S2S_SEQ,
                   "target": target, "batch": tc.train_batch_size, "dtype": "bfloat16",
                   "optimizer": tc.optimizer, "label_smoothing": tc.label_smoothing,
                   "fused_vocab_ce": fused, "span_corruption": bool(tc.span_corruption),
                   "streaming": bool(tc.streaming), "train_steps": steps,
                   "eval_steps": eval_steps, "launches": launches, "first_loss": losses[0],
                   "loss": losses[-1], "eval": ev,
                   "train_samples_per_second_per_chip":
                       hist["train_samples_per_second_per_chip"],
                   "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                   "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall}
            # the export reloads through from_pretrained to the same logits
            tokenizer = load_tokenizer(str(cfg_dir), vocab_size=cfg.vocab_size)
            ds = cli.build_dataset(tc, tokenizer, "train", S2S_SEQ, 8, cfg)
            batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=DEVICE)
                     for k, v in ds[np.arange(8)].items()}
            reloaded, fam, _ = auto.from_pretrained(str(run_dir / "model"), task="seq2seq",
                                                    dtype=torch.bfloat16, device=DEVICE)
            args = [batch[k][:4] for k in ("input_ids", "attention_mask", "decoder_input_ids",
                                           "decoder_attention_mask")]
            with torch.no_grad():
                a_ = trainer.model.eval()(*args)
                b_ = reloaded.eval()(*args)
            check(fam == family and torch.equal(a_, b_),
                  f"{name}: the reloaded export gives other logits")
            row["export_reloads_bit_for_bit"] = True
            del reloaded, a_, b_
            if name in ("t5_small_fused", "t5_small_unfused", "bart_base_fused"):
                n_steps = BART_PROFILED_STEPS if family == "bart" else S2S_PROFILED_STEPS
                # MFU: encoder and decoder tokens at their own FLOPs (obs.flops)
                enc_fpt, dec_fpt = flops.seq2seq_train_flops_per_token(cfg, S2S_SEQ, target)
                per_step = (enc_fpt * int(batch["attention_mask"].sum())
                            + dec_fpt * int(batch["decoder_attention_mask"].sum()))
                prof = _steps_profile(trainer, batch, n_steps, per_step, peak)
                k2 = _kernel_ms_per_step(prof, {k: vocab_step_names(k, "bfloat16")
                                                for k in _K2})
                busy = sum(prof.pop("by_kernel_s").values())
                prof["k2_ms_per_step"] = k2
                prof["k2_share_of_busy"] = (sum(k2.values()) * n_steps / 1e3 / busy
                                            if busy else "not measured")
                if DEVICE == "cuda" and fused:
                    check(all(v > 0 for v in k2.values()),
                          f"{name}: the profile misses a K2 kernel: {k2}")
                row.update(prof)
            if name == "t5_small_fused":
                eval_ds = cli.build_dataset(tc, tokenizer, "test", S2S_SEQ, GEN_ROWS, cfg)
                row["generation"] = _generation_check(run_dir / "model", eval_ds, tc)
            row["run_wall_s"] = time.perf_counter() - t0    # the CLI, reload and profile
            rows[name] = row
            emit(row)
            del trainer
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    finally:
        Trainer.train_step = orig_step
        if saved_peak is None:
            os.environ.pop("HSTD_PEAK_TFLOPS", None)
        else:
            os.environ["HSTD_PEAK_TFLOPS"] = saved_peak
    fused_run, unfused = rows["t5_small_fused"], rows["t5_small_unfused"]
    first_rel = (abs(fused_run["first_loss"] - unfused["first_loss"])
                 / abs(unfused["first_loss"]))
    check(first_rel <= PARITY_BF16_LOSS_RTOL,
          f"the fused and unfused T5 runs' first losses differ by {first_rel} (relative)")
    summary = {"phase": "seq2seq_summary", "card": card,
               "phase_wall_s": time.perf_counter() - phase_t0,
               "run_wall_s": {n: r["run_wall_s"] for n, r in rows.items()},
               "first_loss_fused_over_unfused_rel": first_rel,
               "first_loss_rtol": PARITY_BF16_LOSS_RTOL,
               "samples_per_s": {n: r["train_samples_per_second_per_chip"]
                                 for n, r in rows.items()},
               "busy_ms_per_step": {n: r.get("device_busy_ms_per_step")
                                    for n, r in rows.items() if "profiled_steps" in r},
               "fused_over_unfused_busy": (
                   fused_run["device_busy_ms_per_step"] / unfused["device_busy_ms_per_step"]
                   if isinstance(unfused["device_busy_ms_per_step"], float)
                   else "not measured"),
               "rougeL_f1": {n: r["eval"].get("rougeL_f1") for n, r in rows.items()
                             if "rougeL_f1" in r["eval"]},
               "decode_tokens_per_s": fused_run["generation"]["decode_tokens_per_s"]}
    emit(summary)
    return rows


# -- vocab CE kernels ----------------------------------------------------------

VOCAB_CASES = [
    # name, tokens N, vocab V, hidden H, hidden dtype, label smoothing, tied W
    ("gpt2_bf16", 4096, 50257, 768, "bfloat16", 0.0, False),
    ("eval_bf16", 2048, 50257, 768, "bfloat16", 0.0, False),   # the eval steps' shape
    ("gpt2_fp32", 4096, 50257, 768, "float32", 0.0, False),
    ("ragged", 1000, 1001, 768, "float32", 0.0, False),
    ("h200", 512, 4000, 200, "float32", 0.0, False),
    ("h800", 256, 2000, 800, "float32", 0.0, False),
    ("smooth0.1", 1024, 8192, 768, "float32", 0.1, False),
    ("ties", 512, 4096, 768, "float32", 0.0, True),
    # the fused MLM loss's shapes (mlm phase): K = 1024 gathered rows of
    # B 8 x S 512 at the 0.25 cap, BERT's vocab, H with the decoder bias
    # folded in: BERT-base's 776 and BERT-large's 1032; the eval steps'
    # K = 512 of B 4 x S 512
    ("mlm_base_bf16", 1024, 30522, 776, "bfloat16", 0.0, False),
    ("mlm_large_bf16", 1024, 30522, 1032, "bfloat16", 0.0, False),
    ("mlm_eval_bf16", 512, 30522, 776, "bfloat16", 0.0, False),
    # DeBERTa-v3-base's fused MLM loss (deberta phase): the same K rows at
    # its vocab of 128100, H 768 + 8 bias lanes
    ("mlm_deberta_bf16", 1024, 128100, 776, "bfloat16", 0.0, False),
    ("mlm_deberta_eval_bf16", 512, 128100, 776, "bfloat16", 0.0, False),
    # the fused seq2seq loss's shapes (seq2seq phase): B·T rows of the train
    # batch (8 x 64, smoothing 0.1) and the eval batch (4 x 64, plain CE),
    # span corruption's target of 106 (848 and 424 rows); T5-small's vocab
    # and d_model, BART-base's
    ("t5_bf16", 512, 32128, 512, "bfloat16", 0.1, False),
    ("t5_eval_bf16", 256, 32128, 512, "bfloat16", 0.0, False),
    ("t5_span_bf16", 848, 32128, 512, "bfloat16", 0.1, False),
    ("t5_span_eval_bf16", 424, 32128, 512, "bfloat16", 0.0, False),
    ("bart_bf16", 512, 50265, 768, "bfloat16", 0.1, False),
    ("bart_eval_bf16", 256, 50265, 768, "bfloat16", 0.0, False),
    # the llama phase's causal-LM loss (the untied [V, H] head): TinyLlama's
    # B 4 x S 1024 at H 2048, Mixtral's B 2 x S 512 at H 4096, vocab 32000,
    # and Llama-3's vocab of 128256 at H 4096 (13 chunks of the forward's
    # vocab walk, 26 of the backward's)
    ("tinyllama_ce", 4096, 32000, 2048, "bfloat16", 0.0, False),
    ("mixtral_ce", 1024, 32000, 4096, "bfloat16", 0.0, False),
    ("llama3_vocab_ce", 1024, 128256, 4096, "bfloat16", 0.0, False),
    # Gemma-2B's tied head at its vocab of 256000: the run's B 2 x S 1024
    ("gemma_vocab_ce", 2048, 256000, 2048, "bfloat16", 0.0, False),
]
VOCAB_MAIN = "gpt2_bf16"        # the shape and dtypes the CLI's train steps run
VOCAB_MLM = ("mlm_base_bf16", "mlm_large_bf16", "mlm_eval_bf16")
VOCAB_DEBERTA = ("mlm_deberta_bf16", "mlm_deberta_eval_bf16")
VOCAB_LLAMA = ("tinyllama_ce", "mixtral_ce", "llama3_vocab_ce")
VOCAB_GEMMA = ("gemma_vocab_ce",)
VOCAB_SEQ2SEQ = ("t5_bf16", "t5_eval_bf16", "t5_span_bf16", "t5_span_eval_bf16",
                 "bart_bf16", "bart_eval_bf16")
# the kernels each vocab-CE wrapper launches, by hidden dtype, the main
# kernel first (device time is read per kernel name from a profile);
# ``fused_ce_bwd`` is the joint backward. With bf16 hidden both are wgmma
# routes: the forward per vocab chunk its own split of W and the logits'
# statistics, the combine once; the backward per vocab chunk the split of
# W, dS and the products, hᵀ once for dW and the dH cast once
_DS, _SPLIT = "vocab_ce_ds_wgmma_kernel", "vocab_ce_split_w_kernel"
_HT, _CAST = "vocab_ce_transpose_h_kernel", "vocab_ce_dh_reduce_kernel"
_FWD_SPLIT, _COMBINE = "vocab_ce_fwd_split_w_kernel", "vocab_ce_combine_kernel"
VOCAB_KERNEL_NAMES = {
    ("fused_ce_fwd", "float32"): ("vocab_ce_fwd_kernel", _COMBINE),
    ("fused_ce_fwd", "bfloat16"): ("vocab_ce_fwd_wgmma_kernel", _FWD_SPLIT, _COMBINE),
    ("fused_ce_bwd_dh", "float32"): ("vocab_ce_bwd_dh_kernel", _CAST),
    ("fused_ce_bwd_dh", "bfloat16"): ("vocab_ce_dh_wgmma_kernel", _DS, _SPLIT, _CAST),
    ("fused_ce_bwd_dw", "float32"): ("vocab_ce_bwd_dw_kernel",),
    ("fused_ce_bwd_dw", "bfloat16"): ("vocab_ce_dw_wgmma_kernel", _DS, _SPLIT, _HT),
    ("fused_ce_bwd", "float32"): ("vocab_ce_bwd_dh_kernel", _CAST, "vocab_ce_bwd_dw_kernel"),
    ("fused_ce_bwd", "bfloat16"): (_DS, "vocab_ce_dh_wgmma_kernel", "vocab_ce_dw_wgmma_kernel",
                                   _SPLIT, _HT, _CAST),
}
# kernels that only bf16 hidden launches (their names carry no dtype)
VOCAB_BF16_HELPERS = (_SPLIT, _HT, _FWD_SPLIT)
# a train step runs one joint backward: its kernels split between dH and dW
# so that a step profile counts each once (dH takes the split, dS and the
# cast; dW its product and hᵀ); the forward's split has a name of its own
VOCAB_STEP_NAMES = {"fused_ce_bwd_dh": ("vocab_ce_dh_wgmma_kernel", _DS, _SPLIT, _CAST),
                    "fused_ce_bwd_dw": ("vocab_ce_dw_wgmma_kernel", _HT)}


def vocab_kernel_names(kname: str, dtype: str) -> tuple:
    """The kernels a vocab-CE wrapper launches at hidden dtype ``dtype``:
    with bf16 hidden the wgmma routes at every H, with float32 the
    CUDA-core kernels."""
    return VOCAB_KERNEL_NAMES[(kname, dtype)]


def vocab_step_names(kname: str, dtype: str) -> tuple:
    """The kernels a train step's profile counts for ``kname``: the joint
    backward's kernels shared out between dH and dW (``VOCAB_STEP_NAMES``)
    with bf16 hidden, else the wrapper's own."""
    if dtype == "bfloat16" and kname in VOCAB_STEP_NAMES:
        return VOCAB_STEP_NAMES[kname]
    return vocab_kernel_names(kname, dtype)


def vocab_launch_counts(kname: str, case) -> dict:
    """Each kernel of ``vocab_kernel_names`` with its launches a call at
    ``case``: with bf16 hidden the forward's split and statistics once a
    vocab chunk (``fwd_plan``) and its combine once, the backward's split,
    dS and products once a vocab chunk (``bwd_plan``), hᵀ and the dH cast
    once; every float32 kernel once."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

    name, N, V, H, dt, eps, ties = case
    names = vocab_kernel_names(kname, dt)
    if dt != "bfloat16":
        return dict.fromkeys(names, 1)
    h8 = -(-H // 8) * 8
    plan = vc.fwd_plan if kname == "fused_ce_fwd" else vc.bwd_plan
    chunks = -(-V // plan(N, V, h8)[0])
    return {n: 1 if n in (_HT, _CAST, _COMBINE) else chunks for n in names}


VOCAB_COPIES = 2                # W alone is 154 MB at the GPT-2 shape, 3x the L2
VOCAB_ITERS = 5
VOCAB_REPEATS = 3
CE_NEAR_TIE = 1e-5


def _vocab_inputs(case, gen, device):
    """hidden (LayerNorm-like, unit scale), W (the init's 0.02 scale),
    labels and the loss cotangent g (1 on 90% of the tokens, 0 on the
    rest, like a masked sum: gradients of order 1, so the error bound
    relative to max(1, max|want|) is not loose), drawn on ``gen``'s device
    (the phase's is the card's: its cases draw 2.6 G values, about 30 s
    on the host) and moved to ``device``."""
    import torch

    name, N, V, H, dt, eps, ties = case
    on = gen.device
    h = torch.randn(N, H, generator=gen, device=on).to(device, getattr(torch, dt))
    w = torch.randn(1 if ties else V, H, generator=gen, device=on) * 0.02
    w = w.expand(V, H).contiguous().to(device)
    labels = torch.randint(0, V, (N,), generator=gen, device=on).to(device)
    g = (torch.rand(N, generator=gen, device=on) < 0.9).float().to(device)
    return h, w, labels, g


# bf16 tensor-core passes of the 2·N·V·H logit product each K2 call
# takes on the fp32-exact split route with bf16 hidden: the logits
# h·(W_hi + W_mid + W_lo)ᵀ (3); dH adds dS_hi·W_hi + dS_hi·W_mid +
# dS_lo·W_hi (3); dW adds dSᵀ·h (1: dS is rounded to bf16 by the
# contract); the joint backward takes the logits once for both (7)
CE_TC_PASSES = {"fused_ce_fwd": 3, "fused_ce_bwd_dh": 6, "fused_ce_bwd_dw": 4,
                "fused_ce_bwd": 7}
# fp32 CUDA-core passes: the logits, and the backward's products
CE_FP32_PASSES = {"fused_ce_fwd": 1, "fused_ce_bwd_dh": 2, "fused_ce_bwd_dw": 2,
                  "fused_ce_bwd": 3}


def _ce_work(case) -> dict:
    """Bytes, flops and peak rate of each K2 call's bound: every input
    read once and every output written once (hidden, W, the int32 labels;
    loss, LSE and pred; LSE and g in; dH or dW out, both for the joint
    backward ``fused_ce_bwd``). With bf16 hidden the work is the
    fp32-exact split route on the bf16 tensor cores (``CE_TC_PASSES`` x
    2·N·V·H at 989 TFLOP/s); with fp32 hidden, fp32 products on CUDA
    cores (``CE_FP32_PASSES`` x 2·N·V·H at 67 TFLOP/s)."""
    name, N, V, H, dt, eps, ties = case
    hb = 2 if dt == "bfloat16" else 4
    inputs = N * H * hb + V * H * 4 + N * 4
    logits = 2 * N * V * H
    nbytes = {"fused_ce_fwd": inputs + 3 * N * 4,
              "fused_ce_bwd_dh": inputs + 2 * N * 4 + N * H * hb,
              "fused_ce_bwd_dw": inputs + 2 * N * 4 + V * H * 4,
              "fused_ce_bwd": inputs + 2 * N * 4 + N * H * hb + V * H * 4}
    if dt == "bfloat16":
        return {k: (b, CE_TC_PASSES[k] * logits, BF16_FLOPS_PER_S) for k, b in nbytes.items()}
    return {k: (b, CE_FP32_PASSES[k] * logits, FP32_FLOPS_PER_S) for k, b in nbytes.items()}


def _fwd_scratch_bytes(case) -> int:
    """The bf16 forward's own traffic beside its bound's bytes: the split
    of W (16 bytes a W element: the fp32 read of the split kernel, the
    three bf16 pieces written and read back by the product) and the
    per-tile statistics (20 bytes a 128-id tile and token, written by the
    product and read back by the combine)."""
    name, N, V, H, dt, eps, ties = case
    return 16 * V * H + 2 * 20 * -(-V // 128) * N


def _bwd_scratch_bytes(case) -> int:
    """The bf16 backward's own traffic beyond its bound's bytes: W's five
    split pieces written and read once (20 bytes a W element), dS_hi,
    dS_lo and dS_hiᵀ written and read once (12 bytes an N x V element), hᵀ
    written and read (4 bytes an h element), and the fp32 dH partials
    written and read once a chunk (8 bytes an element a chunk and split)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

    name, N, V, H, dt, eps, ties = case
    v_chunk, splits, _ = vc.bwd_plan(N, V, -(-H // 8) * 8)
    return 20 * V * H + 12 * N * V + 4 * N * H + 8 * -(-V // v_chunk) * splits * N * H


def vocab_ce_phase(cases=None) -> dict:
    """Each K2 kernel against its plain version on every case (``cases``,
    else ``VOCAB_CASES``); times and bounds. Returns the rows by (case,
    kernel)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

    vc.load_kernel()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    results = {}
    for case in VOCAB_CASES if cases is None else cases:
        results.update(_vocab_case(case, gen, torch.device(DEVICE)))
    return results


def _vocab_case(case, gen, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc

    name, N, V, H, dt, eps, ties = case
    sets = [_vocab_inputs(case, gen, dev) for _ in range(VOCAB_COPIES)]
    h, w, lab, g = sets[0]
    loss, lse, pred = vc.fused_ce_fwd(h, w, lab, eps)
    rloss, rlse, rpred = vc.fused_ce_fwd_reference(h, w, lab, eps)
    dh = vc.fused_ce_bwd_dh(h, w, lab, rlse, g, eps)
    rdh = vc.fused_ce_bwd_dh_reference(h, w, lab, rlse, g, eps)
    dw = vc.fused_ce_bwd_dw(h, w, lab, rlse, g, eps)
    rdw = vc.fused_ce_bwd_dw_reference(h, w, lab, rlse, g, eps)
    joint = vc.fused_ce_bwd(h, w, lab, rlse, g, eps)
    again = vc.fused_ce_bwd(h, w, lab, rlse, g, eps)
    fwd_again = vc.fused_ce_fwd(h, w, lab, eps)
    _sync()
    # the joint backward is the lone dH and dW bit for bit, and itself on a
    # second call, as the forward is (no atomics: every sum in a fixed order)
    check(torch.equal(joint[0], dh) and torch.equal(joint[1], dw),
          f"vocab case {name}: the joint backward differs from the lone dH or dW")
    check(torch.equal(joint[0], again[0]) and torch.equal(joint[1], again[1]),
          f"vocab case {name}: two joint backward calls differ")
    check(all(torch.equal(a_, b_) for a_, b_ in zip((loss, lse, pred), fwd_again)),
          f"vocab case {name}: two forward calls differ")
    del again, fwd_again
    compared = {"fused_ce_fwd": [(loss, rloss), (lse, rlse)],
                "fused_ce_bwd_dh": [(dh, rdh)],
                "fused_ce_bwd_dw": [(dw, rdw)],
                "fused_ce_bwd": [(joint[0], rdh), (joint[1], rdw)]}
    # per kernel, the output closest to its limit: its error and limit
    errs, limits = {}, {}
    for kname, pairs in compared.items():
        worst = (-1.0, 0.0, 0.0)
        for got, want in pairs:
            gf, wf = got.float(), want.float()
            e, m = float((gf - wf).abs().max()), float(wf.abs().max())
            lim = _limit(got, m)
            check(bool(torch.isfinite(gf).all()) and e <= lim,
                  f"vocab case {name}: {kname} max_abs_err {e} over {lim} "
                  f"(max |want| {m})")
            worst = max(worst, (e / lim if lim > 0 else 0.0, e, lim))
        _, errs[kname], limits[kname] = worst
    del joint, dh, dw, rdh, rdw
    # pred: the plain argmax, except where the plain top-two gap is a near tie
    s = vc._logits(h, w)
    top2 = s.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < CE_NEAR_TIE * float(s.abs().max())
    del s, top2
    wrong = int(((pred != rpred) & ~near).sum())
    check(wrong == 0, f"vocab case {name}: {wrong} predictions differ off near-ties")
    if ties:
        check(bool((pred == 0).all()), f"vocab case {name}: a tie did not go to id 0")

    fwd_sets = [(h_, w_, l_) for h_, w_, l_, _ in sets]
    bwd_sets = [(h_, w_, l_, vc.fused_ce_fwd_reference(h_, w_, l_, eps)[1], g_)
                for h_, w_, l_, g_ in sets]
    calls = {"fused_ce_fwd": (lambda *a: vc.fused_ce_fwd(*a, eps), fwd_sets),
             "fused_ce_bwd_dh": (lambda *a: vc.fused_ce_bwd_dh(*a, eps), bwd_sets),
             "fused_ce_bwd_dw": (lambda *a: vc.fused_ce_bwd_dw(*a, eps), bwd_sets),
             "fused_ce_bwd": (lambda *a: vc.fused_ce_bwd(*a, eps), bwd_sets)}
    # device time of the wrapper's kernels (profiler), and CUDA events
    # around a loop of wrapper calls (host gaps included)
    names = {k: vocab_kernel_names(k, dt) for k in calls}
    ms = {k: _device_ms(fn, a_, vocab_launch_counts(k, case), iters=VOCAB_ITERS,
                        repeats=VOCAB_REPEATS) for k, (fn, a_) in calls.items()}
    event_ms = {k: _cuda_ms(fn, a_, iters=VOCAB_ITERS) for k, (fn, a_) in calls.items()}
    plain_dh = _cuda_ms(lambda *a: vc.fused_ce_bwd_dh_reference(*a, eps), bwd_sets, iters=3)
    plain_dw = _cuda_ms(lambda *a: vc.fused_ce_bwd_dw_reference(*a, eps), bwd_sets, iters=3)
    plain = {"fused_ce_fwd": _cuda_ms(lambda *a: vc.fused_ce_fwd_reference(*a, eps),
                                      fwd_sets, iters=3),
             "fused_ce_bwd_dh": plain_dh, "fused_ce_bwd_dw": plain_dw,
             "fused_ce_bwd": plain_dh + plain_dw}

    # the library yardstick, two calls: fp32 matmul (TF32 off) and
    # cross_entropy; its autograd backward gives dH and dW together
    def lib_fwd(h_, w_, l_):
        with torch.no_grad():
            F.cross_entropy(torch.matmul(h_.float(), w_.t()), l_, reduction="none",
                            label_smoothing=eps)

    lib_bwd_sets = []
    for h_, w_, l_, g_ in sets:
        hf = h_.float().requires_grad_(True)
        wf = w_.detach().requires_grad_(True)
        with torch.enable_grad():
            out = F.cross_entropy(torch.matmul(hf, wf.t()), l_, reduction="none",
                                  label_smoothing=eps)
        lib_bwd_sets.append((out, (hf, wf), g_))

    def lib_bwd(out, leaves, g_):
        torch.autograd.grad(out, leaves, g_, retain_graph=True)

    lib_fwd_ms = _device_ms(lib_fwd, fwd_sets, iters=VOCAB_ITERS, repeats=VOCAB_REPEATS)
    lib_bwd_ms = _device_ms(lib_bwd, lib_bwd_sets, iters=VOCAB_ITERS, repeats=VOCAB_REPEATS)
    lib_event_fwd = _cuda_ms(lib_fwd, fwd_sets, iters=VOCAB_ITERS)
    lib_event_bwd = _cuda_ms(lib_bwd, lib_bwd_sets, iters=VOCAB_ITERS)
    v_chunk, dh_split_k, scratch = vc.bwd_plan(N, V, -(-H // 8) * 8)
    scratch_ms = _bwd_scratch_bytes(case) / HBM_BYTES_PER_S * 1e3
    fwd_chunk, fwd_scratch = vc.fwd_plan(N, V, -(-H // 8) * 8)
    fwd_scratch_ms = _fwd_scratch_bytes(case) / HBM_BYTES_PER_S * 1e3
    results = {}
    for kname, (nbytes, flops, peak) in _ce_work(case).items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        main = names[kname][0]
        bwd = kname != "fused_ce_fwd"
        row = {"phase": "vocab_kernel", "case": name, "kernel": kname, "N": N, "V": V,
               "H": H, "hidden_dtype": dt, "weight_dtype": "float32",
               "label_smoothing": eps, "tied_weight": ties,
               "kernel_name": main, "kernels": list(names[kname]),
               "route": "wgmma" if "_wgmma_" in main else "CUDA cores",
               "max_abs_err": errs[kname], "max_abs_err_limit": limits[kname],
               "status": "pass", "near_ties": int(near.sum()),
               "kernel_ms": ms[kname], "kernel_event_ms": event_ms[kname],
               "plain_ms": plain[kname],
               "library_ms": lib_bwd_ms if bwd else lib_fwd_ms,
               "library_event_ms": lib_event_bwd if bwd else lib_event_fwd,
               "library": ("autograd backward of torch.matmul + cross_entropy, dH and dW "
                           "together (two calls)" if bwd else
                           "torch.matmul fp32 + cross_entropy (two calls)"),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_peak_flops_per_s": peak,
               "bound_fp32_ms": max(t_bytes, CE_FP32_PASSES[kname] * 2 * N * V * H
                                    / FP32_FLOPS_PER_S * 1e3),
               "bytes": nbytes, "flops": flops,
               # the launch configuration: the fp32 forward's and dH's vocab
               # splits at this N and V; the bf16 routes' vocab chunk, their
               # chunks, dH's split-K, scratch bytes and the scratch's own
               # traffic at the HBM rate
               "fwd_splits": vc.fwd_splits(N, V), "dh_splits": vc.dh_splits(N, V)}
        if bwd and dt == "bfloat16":
            row.update(vocab_chunk=v_chunk, chunks=-(-V // v_chunk), dh_split_k=dh_split_k,
                       scratch_bytes=scratch, scratch_ms=scratch_ms)
        elif dt == "bfloat16":
            row.update(vocab_chunk=fwd_chunk, chunks=-(-V // fwd_chunk),
                       scratch_bytes=fwd_scratch, scratch_ms=fwd_scratch_ms)
        emit(row)
        results[(name, kname)] = row
    del sets, fwd_sets, bwd_sets, lib_bwd_sets
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return results


# -- GPT-2 causal-LM training --------------------------------------------------

# the HF hub's gpt2/config.json widths
GPT2_124M = {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
             "vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
             "n_head": 12, "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
             "resid_pdrop": 0.1, "embd_pdrop": 0.1, "attn_pdrop": 0.1,
             "initializer_range": 0.02, "bos_token_id": 50256, "eos_token_id": 50256}
GPT2_SEQ = 512
GPT2_CLI_STEPS = 20
GPT2_EVAL_SAMPLES = 64
PARITY_ZERO_GRAD = 1e-6


def _lm_batch(n: int, seq: int, device, split: str = "train",
              vocab: int | None = None) -> dict:
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
        ArrayDataset,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    texts, _ = load_text_classification("vendored_reviews", split, max_samples=n)
    ds = ArrayDataset.from_lm_texts(
        WordHashTokenizer(vocab_size=vocab or GPT2_124M["vocab_size"]), texts, seq)
    return {k: torch.from_numpy(v).long().to(device) for k, v in ds.columns.items()}


def _gpt2_step(batch, impl: str, dtype) -> tuple[float, dict]:
    """One train step of GPT-2 124M from seed 0 (dropout 0), the kernels
    (flash causal attention and the fused vocab CE) with ``impl`` "flash",
    the plain path (plain attention, unfused logits and CE) with "xla": the
    loss and every parameter's gradient (fp32 parameters)."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_gpt2
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        gpt2_config_from_hf,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        causal_lm_loss,
        make_fused_causal_lm_loss,
    )

    cfg = gpt2_config_from_hf(GPT2_124M, hidden_dropout=0.0, embd_dropout=0.0,
                              attention_dropout=0.0, attention_impl=impl, dtype=dtype)
    model = init_gpt2(cfg, seed=0, device=DEVICE, trainable=True).train()
    loss_fn = make_fused_causal_lm_loss(model) if impl == "flash" else causal_lm_loss
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def gpt2_parity_phase() -> dict:
    """(a) one fp32 and one bf16 GPT-2 train step, kernels against the
    plain path. Returns the two rows by dtype."""
    import torch

    batch = _lm_batch(8, GPT2_SEQ, DEVICE)
    losses, grads = {}, {}
    for dt in ("float32", "bfloat16"):
        for impl in ("flash", "xla"):
            losses[(dt, impl)], grads[(dt, impl)] = _gpt2_step(batch, impl, getattr(torch, dt))
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    ref = grads[("float32", "xla")]
    rel_loss = (abs(losses[("float32", "flash")] - losses[("float32", "xla")])
                / abs(losses[("float32", "xla")]))
    # a parameter whose exact gradient is 0 holds rounding noise on both
    # sides: held apart, its noise must stay below 1e-5 of the global norm
    total = float(torch.sqrt(sum((g.float() ** 2).sum() for g in ref.values())))
    zero = [n for n, g in ref.items() if float(g.norm()) <= PARITY_ZERO_GRAD * total]
    noise = max((float(grads[(dt, i)][n].norm()) for dt, i in grads
                 if dt == "float32" for n in zero), default=0.0) / total
    rel = {n: float((g - ref[n]).norm() / ref[n].norm())
           for n, g in grads[("float32", "flash")].items() if n not in zero}
    worst = max(rel, key=rel.get)
    row = {"phase": "gpt2_parity", "model": "gpt2 124M widths", "layers": GPT2_124M["n_layer"],
           "batch": 8, "seq": GPT2_SEQ, "dtype": "float32", "tf32": False,
           "kernels": "flash causal attention + fused vocab CE",
           "plain": "plain attention + unfused logits and CE",
           "loss_kernels": losses[("float32", "flash")],
           "loss_plain": losses[("float32", "xla")],
           "loss_rel_err": rel_loss, "loss_rtol": PARITY_LOSS_RTOL,
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
           "grad_rel_l2_tol": PARITY_GRAD_REL_L2, "params": len(rel),
           "zero_grad_params": zero, "zero_grad_noise_over_global": noise}
    emit(row)
    check(rel_loss <= PARITY_LOSS_RTOL, f"gpt2 parity: loss rel err {rel_loss}")
    check(rel[worst] <= PARITY_GRAD_REL_L2, f"gpt2 parity: {worst} grad rel L2 {rel[worst]}")
    check(noise <= PARITY_KEY_BIAS, f"gpt2 parity: zero-gradient noise {noise}")

    # bf16 (the tensor-core flash kernels and the tensor-core dH), held as
    # the bf16 BERT step is (train_parity_phase): every gradient no further
    # from the fp32 plain step's than PARITY_BF16_FACTOR x the plain bf16
    # path's distance plus the fp32 noise floor; the zero-gradient
    # parameters' noise below PARITY_BF16_KEY_BIAS of the global norm
    g16, ref16 = grads[("bfloat16", "flash")], grads[("bfloat16", "xla")]
    loss16, loss16_ref = losses[("bfloat16", "flash")], losses[("bfloat16", "xla")]
    floor = PARITY_KEY_BIAS * total
    dist = {n: float((g16[n] - ref[n]).norm()) for n in ref}
    dist_plain = {n: float((ref16[n] - ref[n]).norm()) for n in ref}
    ratio = {n: (dist[n] - floor) / dist_plain[n] if dist_plain[n] > 0 else
             (0.0 if dist[n] <= floor else float("inf")) for n in ref if n not in zero}
    worst16 = max(ratio, key=ratio.get)
    noise16 = {i: max((float(g[n].norm()) for n in zero), default=0.0) / total
               for i, g in (("kernels", g16), ("plain", ref16))}
    loss_rel16 = abs(loss16 - loss16_ref) / abs(loss16_ref)
    row16 = {"phase": "gpt2_parity", "model": "gpt2 124M widths",
             "layers": GPT2_124M["n_layer"], "batch": 8, "seq": GPT2_SEQ, "dtype": "bfloat16",
             "kernels": row["kernels"], "plain": row["plain"],
             "loss_kernels": loss16, "loss_plain": loss16_ref,
             "loss_fp32": losses[("float32", "xla")],
             "loss_rel_err": loss_rel16, "loss_rtol": PARITY_BF16_LOSS_RTOL,
             "grad_dist_ratio_max": ratio[worst16], "grad_dist_ratio_worst_param": worst16,
             "grad_dist_ratio_tol": PARITY_BF16_FACTOR,
             "grad_dist_ratio_top5": sorted(ratio.values(), reverse=True)[:5],
             "zero_grad_params": zero, "zero_grad_noise_over_global": noise16,
             "zero_grad_tol": PARITY_BF16_KEY_BIAS,
             "kernels_vs_fp32_rel_l2_max": max(dist[n] / ref[n].norm().item() for n in ratio),
             "plain_vs_fp32_rel_l2_max": max(dist_plain[n] / ref[n].norm().item()
                                             for n in ratio),
             "params": len(ratio)}
    emit(row16)
    check(loss_rel16 <= PARITY_BF16_LOSS_RTOL, f"bf16 gpt2 parity: loss rel err {loss_rel16}")
    check(ratio[worst16] <= PARITY_BF16_FACTOR,
          f"bf16 gpt2 parity: {worst16} gradient is {dist[worst16]} from fp32, plain "
          f"bf16 {dist_plain[worst16]} (floor {floor})")
    check(max(noise16.values()) <= PARITY_BF16_KEY_BIAS,
          f"bf16 gpt2 parity: zero-gradient noise {noise16}")
    return {"float32": row, "bfloat16": row16}


_K2 = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")
_K1 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def gpt2_cli_phase(work: Path) -> dict:
    """(b) the causal-LM training CLI's main path at its defaults, counted."""
    import math

    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    cfg_dir, out_dir, model_dir = work / "config", work / "output", work / "model"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.json").write_text(json.dumps(GPT2_124M))
    argv = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
            "--task", "causal-lm", "--fused_vocab_ce", "true",
            "--dataset", "vendored_reviews", "--epochs", "1",
            "--steps_per_epoch", str(GPT2_CLI_STEPS),
            "--max_eval_samples", str(GPT2_EVAL_SAMPLES),
            "--output_data_dir", str(out_dir), "--model_dir", str(model_dir),
            "--log_every_steps", "10", "--device", DEVICE]
    kernels = [(vc, k) for k in _K2] + [(fa, k) for k in _K1]
    for mod, k in kernels:
        getattr(mod, k).launches = 0
    t0 = time.perf_counter()
    results, trainer = cli.run(argv)
    _sync()
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, k).launches for mod, k in kernels}
    cfg = trainer.model.config
    train_steps = trainer.step
    eval_steps = math.ceil(GPT2_EVAL_SAMPLES / trainer.config.eval_batch_size)
    L = cfg.num_layers
    check(cfg.dtype == torch.bfloat16 and cfg.attention_impl == "flash"
          and cfg.attention_dropout > 0 and trainer.config.fused_vocab_ce
          and trainer.config.max_seq_length == 512 and trainer.config.train_batch_size == 8
          and trainer.config.eval_batch_size == 4, "the CLI did not run at its defaults")
    check(train_steps == GPT2_CLI_STEPS, f"{train_steps} train steps, wanted {GPT2_CLI_STEPS}")
    check(launches["fused_ce_fwd"] == train_steps + eval_steps,
          f"fused_ce_fwd launches {launches['fused_ce_fwd']} != {train_steps} + {eval_steps}")
    for k in ("fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        check(launches[k] == train_steps, f"{k} launches {launches[k]} != {train_steps}")
    # train steps take the unfused dropout softmax (attn_pdrop > 0), eval
    # steps the flash forward
    check(launches["flash_fwd"] == L * eval_steps,
          f"flash_fwd launches {launches['flash_fwd']} != {L} x {eval_steps}")
    hist, ev = results["train"], results["eval"]
    check(all(math.isfinite(x) for x in hist["loss"]) and math.isfinite(ev["eval_loss"]),
          "non-finite loss")
    tr = read_results_file(str(out_dir / "train_results.txt"))
    er = read_results_file(str(out_dir / "eval_results.txt"))
    check(list(tr) == TRAIN_RESULT_KEYS, f"train_results.txt keys {list(tr)}")
    check(list(er) == EVAL_RESULT_KEYS, f"eval_results.txt keys {list(er)}")

    # the export reloads into the port with identical logits
    batch = _lm_batch(4, GPT2_SEQ, DEVICE, split="test")
    reloaded, _, _ = auto.from_pretrained(str(model_dir), task="causal-lm",
                                          dtype=torch.bfloat16, device=DEVICE,
                                          attention_impl="flash")
    model = trainer.model.eval()
    with torch.no_grad():
        a = model(batch["input_ids"], batch["attention_mask"])
        b = reloaded.eval()(batch["input_ids"], batch["attention_mask"])
    check(torch.equal(a, b), "reloaded model.safetensors gives other logits")
    del reloaded, a, b

    # the device's idle share over more train steps: wall unprofiled, then
    # device busy time from a profiled run of as many steps
    extra = [_lm_batch(8, GPT2_SEQ, DEVICE)] * 6
    steps_wall, by_kernel = _timed_then_profiled(trainer, extra)
    busy = sum(by_kernel.values())
    k2_s = {k: sum(v for n, v in by_kernel.items()
                   if any(c in n for c in vocab_step_names(k, "bfloat16")))
            for k in _K2}
    if DEVICE == "cuda":   # the profile names the kernels the train step ran
        for k in _K2:
            main = VOCAB_KERNEL_NAMES[(k, "bfloat16")][0]
            check(any(main in n for n in by_kernel), f"no {main} in the GPT-2 train profile")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    row = {"phase": "gpt2_train", "model": "gpt2 124M widths (random init, seed 42)",
           "layers": L, "dtype": "bfloat16", "seq": 512, "batch": 8, "eval_batch": 4,
           "optimizer": trainer.config.optimizer, "train_steps": train_steps,
           "eval_steps": eval_steps, "launches": launches,
           "loss": hist["loss"], "eval_loss": ev["eval_loss"],
           "eval_accuracy": ev["eval_accuracy"],
           "train_samples_per_second_per_chip": hist["train_samples_per_second_per_chip"],
           "step_time_s": trainer.meter.avg_step_time,
           "train_runtime_s": hist["train_runtime"], "cli_wall_s": wall,
           "profiled_steps": len(extra), "steps_wall_s": steps_wall,
           "step_time_unprofiled_s": steps_wall / len(extra),
           "device_busy_s": busy if busy else "not measured",
           "idle_share": 1.0 - busy / steps_wall if busy else "not measured",
           "k2_kernel_s": k2_s,
           "k2_share_of_busy": sum(k2_s.values()) / busy if busy else "not measured",
           "top_kernels_s": [[k[:80], v] for k, v in top]}
    emit(row)
    return row


# -- decoding (sampling, beam, speculative, chunked prefill, int8) -----------------

DECODE_ROWS = 8                 # prompts from the vendored reviews, right-padded
DECODE_PROMPT = 128             # tokens at most
DECODE_NEW = 64
DECODE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
DECODE_SEED = 7
DECODE_BEAMS = 4
DECODE_DRAFT_LAYERS = 4         # self_draft's first blocks
DECODE_K = 4
DECODE_CHUNK = 32
DECODE_PROFILED_NEW = 16        # the profiled call's new tokens: its trace's size
QUANT_CORR = 0.999              # tests/test_quant.py's quality contract
QUANT_REL = 0.05
S2S_DECODE_NEW = 64
S2S_DRAFT_LAYERS = 2
PREDICT_NEW = 32


def _near_tie_steps(scores, tokens, eos: int) -> list:
    """Per row, the number of leading steps before the first one whose
    top-2 logit gap is below ``NEAR_TIE`` (steps after the row's EOS are
    no ties: both sides pad there)."""
    top2 = scores.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).tolist()
    out = []
    for row, gap in zip(tokens.tolist(), gaps):
        stop = row.index(eos) + 1 if eos in row else len(row)
        out.append(next((j for j, gp in enumerate(gap[:stop]) if gp < NEAR_TIE), len(row)))
    return out


def _agree(name: str, got, want, steps: list) -> int:
    """``got`` equals ``want`` on each row's first ``steps[r]`` tokens;
    returns the tokens compared."""
    for r, n in enumerate(steps):
        check(got[r, :n].tolist() == want[r, :n].tolist(),
              f"decode {name}: row {r} differs from greedy before any near-tie "
              f"({got[r, :n].tolist()} vs {want[r, :n].tolist()})")
    return sum(steps)


def _decode_timing(run, rows: int, new: int, profiled: bool = True) -> tuple:
    """``run(max_new_tokens)`` timed: TTFT (a call for one token), the
    wall of a full call and its decode tokens/s, the peak allocated
    memory, then (``profiled``) the idle share of a call for
    ``DECODE_PROFILED_NEW`` tokens: 1 - its device busy time under the
    profiler over its wall unprofiled (a full call's trace takes the
    profiler 10-20 s to read). Returns (row, the full call's output)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(1)
    _sync()
    t0 = time.perf_counter()
    run(1)
    _sync()
    ttft = time.perf_counter() - t0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run(new)
    _sync()
    wall = time.perf_counter() - t0
    row = {"ttft_s": ttft, "wall_s": wall,
           "decode_tokens_per_sec": rows * (new - 1) / max(wall - ttft, 1e-9),
           "tokens_per_sec": rows * new / wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() if DEVICE == "cuda"
           else "not measured"}
    if profiled:
        short = min(new, DECODE_PROFILED_NEW)
        t0 = time.perf_counter()
        run(short)
        _sync()
        short_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                                 else ProfilerActivity.CPU]) as prof:
            run(short)
            _sync()
        busy = sum(_device_seconds_by_kernel(prof).values())
        row.update(profiled_new_tokens=short, profiled_wall_s=short_wall,
                   device_busy_s=busy if busy else "not measured",
                   idle_share=1.0 - busy / short_wall if busy else "not measured")
    return row, out


def _decode_prompts(tokenizer, n: int, width: int):
    """``n`` vendored test reviews as right-padded prompts of at most
    ``width`` tokens: (ids, mask) on the device."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )

    texts, _ = load_text_classification("vendored_reviews", "test", max_samples=n)
    enc = tokenizer(texts, max_length=width, padding="longest")
    return (torch.as_tensor(enc["input_ids"], device=DEVICE).long(),
            torch.as_tensor(enc["attention_mask"], device=DEVICE).long())


def decode_phase(model_dir: Path, card: str) -> dict:
    """(a) GPT-2 124M decoding from the export ``gpt2_cli_phase`` wrote (20
    steps on the reviews), fp32 with TF32 off: greedy, sampled twice with
    one seed (identical), beam 4 (beam 1 equals greedy), speculative with
    ``self_draft(4)`` and k 4 (tokens equal greedy up to the first
    near-tie), chunked prefill (the same), the int8 KV cache, and the int8
    weight-only model (logits held to the JAX quality contract); each
    timed (TTFT, decode tokens/s, busy, idle share, peak memory) and again
    in bf16 (timings only)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import (
        quantize_for_generation,
    )

    tokenizer = load_tokenizer(str(model_dir))
    ids, mask = _decode_prompts(tokenizer, DECODE_ROWS, DECODE_PROMPT)
    B, T = ids.shape[0], DECODE_NEW
    rows: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        t_setup = time.perf_counter()
        model, _, cfg = auto.from_pretrained(str(model_dir), task="causal-lm", dtype=dtype,
                                             device=DEVICE)
        model.eval().requires_grad_(False)
        int8_kv = _kv_twin(model, "int8")
        t_quant = time.perf_counter()
        qmodel, qstats = quantize_for_generation(model)
        qstats = dict(qstats, quantize_s=time.perf_counter() - t_quant,
                      setup_s=time.perf_counter() - t_setup)
        draft = gen.self_draft(model, DECODE_DRAFT_LAYERS)
        spec_stats = {}

        def speculative(n):
            out, spec_stats[n] = gen.generate_speculative(
                model, draft, ids, mask, max_new_tokens=n, speculate_k=DECODE_K,
                return_stats=True)
            return out

        runs = {
            "greedy": lambda n: gen.generate_causal(model, ids, mask, max_new_tokens=n),
            "sampled": lambda n: gen.generate_causal(model, ids, mask, max_new_tokens=n,
                                                     seed=DECODE_SEED, **DECODE_SAMPLING),
            "beam4": lambda n: gen.beam_search_causal(model, ids, mask, num_beams=DECODE_BEAMS,
                                                      max_new_tokens=n),
            "speculative": speculative,
            "chunked_prefill": lambda n: gen.generate_causal(model, ids, mask, max_new_tokens=n,
                                                             prefill_chunk=DECODE_CHUNK),
            "int8_kv": lambda n: gen.generate_causal(int8_kv, ids, mask, max_new_tokens=n),
            "int8_weights": lambda n: gen.generate_causal(qmodel, ids, mask, max_new_tokens=n),
        }
        outs = {}
        for name, run in runs.items():
            t_run = time.perf_counter()
            row, out = _decode_timing(run, B, T, profiled=fp32)
            row["run_s"] = time.perf_counter() - t_run
            row.update({"phase": "decode", "run": name, "model": "gpt2 124M, 20 trained steps",
                        "dtype": str(dtype).replace("torch.", ""), "rows": B,
                        "prompt_width": int(ids.shape[1]), "new_tokens": T})
            if name == "speculative":
                st = spec_stats[T]            # the full call's
                row.update(st, acceptance_rate=(st["accepted_per_window"] - 1) / DECODE_K,
                           tokens_per_target_pass=st["accepted_per_window"])
            if name == "int8_weights":
                row.update(qstats)
            outs[name] = out
            rows[(name, row["dtype"])] = row
        if fp32:
            greedy, scores = gen.generate_causal(model, ids, mask, max_new_tokens=T,
                                                 output_scores=True)
            check(torch.equal(greedy, outs["greedy"]), "greedy decode is not repeatable")
            check(torch.equal(runs["sampled"](T), outs["sampled"]),
                  "two sampled runs with one seed differ")
            check(bool(((outs["sampled"] >= 0) & (outs["sampled"] < cfg.vocab_size)).all()),
                  "sampled ids outside the vocabulary")
            steps = _near_tie_steps(scores, greedy, cfg.eos_token_id)
            near = sum(n < T for n in steps)
            beam1 = gen.beam_search_causal(model, ids, mask, num_beams=1, max_new_tokens=T)
            gates = {"near_tie_rows": near,
                     "speculative_tokens_compared": _agree("speculative", outs["speculative"],
                                                           greedy, steps),
                     "chunked_tokens_compared": _agree("chunked_prefill",
                                                       outs["chunked_prefill"], greedy, steps),
                     "beam1_tokens_compared": _agree("beam1", beam1, greedy, steps),
                     "int8_kv_rows_equal_greedy": sum(
                         torch.equal(a, b) for a, b in zip(outs["int8_kv"], greedy))}
            with torch.inference_mode():
                fp = model(ids, mask).double()
                q8 = qmodel(ids, mask).double()
            real = mask.bool()
            fp, q8 = fp[real], q8[real]
            corr = float(torch.corrcoef(torch.stack([fp.flatten(), q8.flatten()]))[0, 1])
            rel = float((q8 - fp).abs().max() / (fp.abs().max() + 1e-9))
            check(corr > QUANT_CORR and rel < QUANT_REL,
                  f"int8 weight-only logits: correlation {corr}, max relative error {rel}")
            gates.update(int8_logits_correlation=corr, int8_logits_max_rel_err=rel,
                         weight_bytes_fp32=sum(p.numel() * p.element_size()
                                               for p in model.parameters()),
                         weight_bytes_int8=sum(p.numel() * p.element_size()
                                               for p in qmodel.parameters()))
            rows[("gates", "float32")] = dict(phase="decode_gates", **gates)
            del greedy, scores, fp, q8
        del model, int8_kv, qmodel, draft
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    for row in rows.values():
        emit(row)
    return rows


def _s2s_sources(vocab: int, n: int, width: int):
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        synthetic_summarization,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )

    docs, _ = synthetic_summarization(n, seed=3)
    enc = WordHashTokenizer(vocab_size=vocab)(docs, max_length=width, padding="longest")
    return (torch.as_tensor(enc["input_ids"], device=DEVICE).long(),
            torch.as_tensor(enc["attention_mask"], device=DEVICE).long())


def _teacher_forced(model, src, mask, tokens):
    """fp32 log-probabilities of ``tokens`` [B, T] under a teacher-forced
    decode (the first from ``decoder_start_token_id``) and the logits."""
    import torch

    cfg = model.config
    start = torch.full_like(tokens[:, :1], cfg.decoder_start_token_id).long()
    dec = torch.cat([start, tokens[:, :-1].long()], 1)
    with torch.inference_mode():
        logits = model(src, mask, dec).float()
    logp = torch.log_softmax(logits, -1).gather(-1, tokens.long()[..., None])[..., 0]
    if getattr(cfg, "forced_bos_token_id", None) is not None:
        logp[:, 0] = 0.0                 # the forced first token is a point mass
    return logp, logits


def seq2seq_decode_phase(work: Path) -> dict:
    """(b) T5-small and BART-base widths (``config.json`` written, random
    weights from seed 0), fp32: greedy, sampled, beam 4 (its score at
    least greedy's), speculative with a 2-layer draft of the same vocabulary
    (T5: tokens equal greedy up to the first near-tie; BART is refused, as
    in the JAX package) and the int8 weight-only model (its logits'
    correlation and error read, not gated); tokens/s of each."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.quant import (
        quantize_for_generation,
    )

    rows = {}
    T = S2S_DECODE_NEW
    for name, hf in (("t5_small", T5_SMALL), ("bart_base", BART_BASE)):
        model, _, cfg = auto.from_pretrained(str(_config_dir(work / name, hf)),
                                             task="seq2seq", device=DEVICE, seed=0)
        model.eval().requires_grad_(False)
        src, mask = _s2s_sources(cfg.vocab_size, DECODE_ROWS, S2S_SEQ)
        B = src.shape[0]
        qmodel, qstats = quantize_for_generation(model)
        runs = {
            "greedy": lambda n: gen.generate(model, src, mask, max_new_tokens=n),
            "sampled": lambda n: gen.generate(model, src, mask, max_new_tokens=n,
                                              seed=DECODE_SEED, **DECODE_SAMPLING),
            "beam4": lambda n: gen.beam_search_generate(model, src, mask,
                                                        num_beams=DECODE_BEAMS,
                                                        max_new_tokens=n, return_scores=True),
            "int8_weights": lambda n: gen.generate(qmodel, src, mask, max_new_tokens=n),
        }
        spec_stats = {}
        if name.startswith("t5"):
            draft, _, _ = auto.from_pretrained(
                str(_config_dir(work / f"{name}_draft", dict(
                    hf, num_layers=S2S_DRAFT_LAYERS, num_decoder_layers=S2S_DRAFT_LAYERS))),
                task="seq2seq", device=DEVICE, seed=1)

            def speculative(n):
                out, spec_stats[n] = gen.generate_speculative_seq2seq(
                    model, draft, src, mask, max_new_tokens=n, speculate_k=DECODE_K,
                    return_stats=True)
                return out

            runs["speculative"] = speculative
        outs = {}
        for run_name, run in runs.items():
            row, out = _decode_timing(run, B, T, profiled=False)
            row.update({"phase": "seq2seq_decode", "model": f"{name} widths (random, seed 0)",
                        "run": run_name, "dtype": "float32", "rows": B,
                        "source_width": int(src.shape[1]), "new_tokens": T})
            if run_name == "speculative":
                row.update(spec_stats[T])
            if run_name == "int8_weights":
                row.update(qstats)
            outs[run_name] = out
            rows[(name, run_name)] = row
        greedy = outs["greedy"]
        logp, logits = _teacher_forced(model, src, mask, greedy)
        eos = cfg.eos_token_id
        lens = [row.index(eos) + 1 if eos in row else T for row in greedy.tolist()]
        greedy_score = [float(logp[r, :n].sum()) / n for r, n in enumerate(lens)]
        beam_ids, beam_scores = outs["beam4"]
        for r, (b, g) in enumerate(zip(beam_scores.tolist(), greedy_score)):
            check(b >= g - 1e-4, f"{name} beam 4 row {r}: score {b} below greedy's {g}")
        gates = {"phase": "seq2seq_decode_gates", "model": name,
                 "beam_scores": beam_scores.tolist(), "greedy_scores": greedy_score}
        if "speculative" in outs:
            steps = _near_tie_steps(logits, greedy, eos)
            gates["near_tie_rows"] = sum(n < T for n in steps)
            gates["speculative_tokens_compared"] = _agree(
                f"{name} speculative", outs["speculative"], greedy, steps)
        else:
            try:
                gen.generate_speculative_seq2seq(model, model, src, mask, max_new_tokens=2)
                check(False, f"{name}: speculative seq2seq was not refused")
            except ValueError as e:
                gates["speculative"] = f"refused: {e}"
        # read, not gated: random weights at these widths (T5's unscaled
        # attention logits above all) amplify the rounding of int8 weights
        _, q_logits = _teacher_forced(qmodel, src, mask, greedy)
        check(bool(torch.isfinite(q_logits).all()), f"{name}: non-finite int8 logits")
        fp, q8 = logits.double().flatten(), q_logits.double().flatten()
        gates.update(int8_logits_correlation=float(torch.corrcoef(torch.stack([fp, q8]))[0, 1]),
                     int8_logits_max_rel_err=float((q8 - fp).abs().max()
                                                   / (fp.abs().max() + 1e-9)))
        rows[(name, "gates")] = gates
        del model, qmodel, logits, q_logits
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    for row in rows.values():
        emit(row)
    return rows


PREDICT_ROW_KEYS = {"seq-cls": ["text", "label", "probs"], "mlm": ["text", "fills"],
                    "causal-lm": ["text", "generated", "generated_ids"],
                    "seq2seq": ["text", "generated", "generated_ids"]}


def predict_phase(work: Path, exports: dict) -> dict:
    """(c) the predict CLI, each run a subprocess, all started together, on
    exports the script wrote: seq-cls (the BERT CLI's), mlm (BERT-base
    MLM's), causal-lm (GPT-2's: beam 4, sampled, ``--self_speculate_layers
    4``), seq2seq (T5-small's). Each row carries the JAX script's keys;
    the generated ids equal the direct call's on the same model and
    tokens."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import predict
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as gen

    text = "a quietly moving film with a plot that never quite lands"
    runs = {
        "seq-cls": ("seq-cls", exports["seq-cls"], ["--text", text]),
        "mlm": ("mlm", exports["mlm"], ["--text", "the movie was [MASK] and long"]),
        "causal-lm_beam": ("causal-lm", exports["causal-lm"],
                           ["--text", text, "--num_beams", str(DECODE_BEAMS)]),
        "causal-lm_sampled": ("causal-lm", exports["causal-lm"],
                              ["--text", text, "--temperature", "0.8", "--top_k", "50",
                               "--top_p", "0.9", "--seed", str(DECODE_SEED)]),
        "causal-lm_self_speculative": ("causal-lm", exports["causal-lm"],
                                       ["--text", text, "--self_speculate_layers",
                                        str(DECODE_DRAFT_LAYERS)]),
        "seq2seq": ("seq2seq", exports["seq2seq"], ["--text", "summarize: " + text]),
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.predict", "--model_dir", str(d), "--task", task,
         "--max_new_tokens", str(PREDICT_NEW), "--max_seq_length", "128",
         "--device", DEVICE, *extra],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (task, d, extra) in runs.items()}
    outs = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"predict {name} exited {proc.returncode}: {err[-2000:]}")
        outs[name] = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    wall = time.perf_counter() - t0
    result = {}
    for name, (task, d, extra) in runs.items():
        got = outs[name]
        check(len(got) == 1 and list(got[0]) == PREDICT_ROW_KEYS[task],
              f"predict {name}: rows {got}")
        row = {"phase": "predict", "run": name, "keys": list(got[0])}
        if task in ("causal-lm", "seq2seq"):
            args = predict.build_parser().parse_args(
                ["--model_dir", str(d), "--task", task, "--max_new_tokens", str(PREDICT_NEW),
                 "--max_seq_length", "128", "--device", DEVICE, *extra])
            model, _, cfg = auto.from_pretrained(str(d), task=task, device=DEVICE)
            model.eval().requires_grad_(False)
            enc = predict._encode(load_tokenizer(str(d), vocab_size=cfg.vocab_size),
                                  [args.text], None,
                                  min(args.max_seq_length, getattr(
                                      cfg, "max_position_embeddings", args.max_seq_length)))
            ids = torch.as_tensor(enc["input_ids"], device=DEVICE).long()
            mask = torch.as_tensor(enc["attention_mask"], device=DEVICE).long()
            if task == "seq2seq":
                want = gen.generate(model, ids, mask, max_new_tokens=PREDICT_NEW)
            elif args.num_beams > 1:
                want = gen.beam_search_causal(model, ids, mask, num_beams=args.num_beams,
                                              max_new_tokens=PREDICT_NEW)
            elif args.self_speculate_layers:
                want = gen.generate_speculative(
                    model, gen.self_draft(model, args.self_speculate_layers), ids, mask,
                    max_new_tokens=PREDICT_NEW, speculate_k=args.speculate_k)
            else:
                want = gen.generate_causal(model, ids, mask, max_new_tokens=PREDICT_NEW,
                                           temperature=args.temperature, top_k=args.top_k,
                                           top_p=args.top_p, seed=args.seed)
            check(got[0]["generated_ids"] == want[0].tolist(),
                  f"predict {name}: ids {got[0]['generated_ids']} != direct "
                  f"{want[0].tolist()}")
            row["generated_ids_equal_direct_call"] = True
            del model
        result[name] = row
    result["wall_s"] = wall
    emit({"phase": "predict", "runs": list(runs), "wall_s": wall,
          "rows": {k: v for k, v in result.items() if k != "wall_s"}})
    return result


# -- packing, LoRA, DeBERTa ----------------------------------------------------

class _Recorder:
    """Wraps ``Trainer.train_step`` while active: each step's loss, the
    real and padded tokens of its batch, the fused MLM loss's own
    ``ce_dropped``; with ``stop_after`` it raises :class:`_Interrupt` before
    that many steps have run."""

    def __init__(self):
        self.losses, self.real, self.padded, self.ce_dropped = [], [], [], []
        self.stop_after = None

    def reset(self, stop_after=None):
        self.__init__()
        self.stop_after = stop_after

    def __enter__(self):
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
            Trainer,
        )

        rec, orig = self, Trainer.train_step
        self._orig = orig

        def train_step(trainer, batch):
            if rec.stop_after is not None and len(rec.losses) == rec.stop_after:
                raise _Interrupt
            loss_fn = trainer.loss_fn

            def recorded(model, batch_):
                loss, sums = loss_fn(model, batch_)
                if "ce_dropped" in sums:
                    rec.ce_dropped.append(sums["ce_dropped"].detach())
                return loss, sums

            trainer.loss_fn = recorded
            try:
                out = orig(trainer, batch)
            finally:
                trainer.loss_fn = loss_fn
            rec.losses.append(out["loss"])
            rec.real.append(batch["attention_mask"].sum())
            rec.padded.append(batch["attention_mask"].numel())
            return out

        Trainer.train_step = train_step
        return self

    def __exit__(self, *exc):
        from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
            Trainer,
        )

        Trainer.train_step = self._orig
        return False


def _counted_run(argv: list) -> tuple:
    """The training CLI on ``argv`` with every K1 and K2 counter set to 0
    just before: ``(results, trainer, launches, wall seconds)``."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    counters = [(fa, k) for k in _K1] + [(vc, k) for k in _K2]
    for mod, k in counters:
        getattr(mod, k).launches = 0
    t0 = time.perf_counter()
    results, trainer = cli.run(argv)
    _sync()
    return (results, trainer, {k: getattr(mod, k).launches for mod, k in counters},
            time.perf_counter() - t0)


def _slice_argv(cfg_dir: Path, run_dir: Path, task: str, steps: int, eval_samples: int,
                extra: list) -> list:
    """The CLI at its defaults (bf16, sequence 512, batch 8, eval batch 4,
    AdamW) on the vendored reviews from a seeded config; ``eval_samples``
    0 skips the eval."""
    argv = ["--model_name_or_path", str(cfg_dir), "--from_scratch", "true", "--task", task,
            "--dataset", "vendored_reviews", "--epochs", "1",
            "--steps_per_epoch", str(steps), "--output_data_dir", str(run_dir / "out"),
            "--model_dir", str(run_dir / "model"), "--log_every_steps", "10",
            "--device", DEVICE]
    argv += (["--max_eval_samples", str(eval_samples)] if eval_samples
             else ["--do_eval", "false"])
    return argv + extra


def _config_dir(run_dir: Path, hf: dict) -> Path:
    cfg_dir = run_dir / "config"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    (cfg_dir / "config.json").write_text(json.dumps(hf))
    return cfg_dir


def _first_rows(trainer, split: str, n: int, max_samples: int) -> dict:
    """The first ``n`` rows of the run's own ``split`` dataset (built by the
    CLI's ``build_dataset`` from ``max_samples`` examples) on the card."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        load_tokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import cli

    tc, cfg = trainer.config, trainer.model.config
    seq = min(tc.max_seq_length, cfg.max_position_embeddings)
    ds = cli.build_dataset(tc, load_tokenizer(tc.model_name_or_path, vocab_size=cfg.vocab_size),
                           split, seq, max_samples, cfg)
    check(len(ds) >= n, f"{len(ds)} {split} rows, wanted {n}")
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=DEVICE)
            for k, v in ds[np.arange(n)].items()}, len(ds)


def _eval_steps(trainer, eval_samples: int) -> int:
    """The eval steps a run took: its eval set (packed rows, where it
    packs) over the eval batch of 4."""
    if not eval_samples:
        return 0
    _, n = _first_rows(trainer, "test", 1, eval_samples)
    return math.ceil(n / trainer.config.eval_batch_size)


def _peak_env(peak):
    """``HSTD_PEAK_TFLOPS`` set to the card's peak while a phase runs, so
    the CLI's history carries ``train_mfu``; returns the restore."""
    import os

    saved = os.environ.get("HSTD_PEAK_TFLOPS")
    if peak:
        os.environ["HSTD_PEAK_TFLOPS"] = str(peak)

    def restore():
        if saved is None:
            os.environ.pop("HSTD_PEAK_TFLOPS", None)
        else:
            os.environ["HSTD_PEAK_TFLOPS"] = saved
    return restore


def _profiled(trainer, batch, steps: int, peak, task: str) -> dict:
    """``steps`` more train steps on ``batch`` (:func:`_steps_profile`):
    busy, idle, MFU over the batch's real tokens, and the K1 and K2
    kernels' device ms per step."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        bias_fold_width,
    )

    cfg = trainer.model.config
    fpt = flops.train_flops_per_token(cfg, task, batch["input_ids"].shape[1])
    prof = _steps_profile(trainer, batch, steps, fpt * int(batch["attention_mask"].sum()),
                          peak)
    width = (bias_fold_width(getattr(cfg, "embedding_size", None) or cfg.hidden_size)
             if task == "mlm" else cfg.hidden_size)
    prof["k1_ms_per_step"] = _kernel_ms_per_step(
        prof, {k: FLASH_KERNEL_NAMES[(k, "bfloat16")] for k in _K1})
    prof["k2_ms_per_step"] = _kernel_ms_per_step(
        prof, {k: vocab_step_names(k, "bfloat16") for k in _K2})
    prof.pop("by_kernel_s")
    return prof


PACK_STEPS = 20
PACK_EVAL_SAMPLES = 64          # 16 eval steps unpacked at the eval batch of 4
PACK_PROFILED_STEPS = 6
PACK_EXACT_EXAMPLES = 16
PACK_EXACT_RTOL = 1e-5


def _packing_runs() -> list:
    """(name, published config, task, CLI arguments) of the packing phase's
    runs, each ``PACK_STEPS`` steps at the CLI's defaults."""
    fused = ["--fused_vocab_ce", "true"]
    return [("gpt2_unpacked", GPT2_124M, "causal-lm", fused),
            ("gpt2_segment", GPT2_124M, "causal-lm", fused + ["--segment_packing", "true"]),
            ("gpt2_packed", GPT2_124M, "causal-lm", fused + ["--packed_sequences", "true"]),
            ("bert_mlm_segment", BERT_BASE, "mlm",
             fused + ["--segment_packing", "true", "--mlm_static_masking", "true"])]


def _packing_exactness() -> dict:
    """(d) ``PACK_EXACT_EXAMPLES`` test reviews packed and one per row, fp32
    (TF32 off, dropout 0), through K2: the fused causal-LM loss of GPT-2
    124M and the fused MLM loss of BERT-base (static masks), each packed
    loss sum within ``PACK_EXACT_RTOL`` of the unpacked one and the counts
    equal (the JAX ``test_packed_{causal_lm,mlm}_loss_matches_unpacked``)."""
    import numpy as np
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.pipeline import (
        ArrayDataset,
        pack_examples,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.sources import (
        load_text_classification,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data.tokenization import (
        WordHashTokenizer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
        init_gpt2,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.gpt2 import (
        gpt2_config_from_hf,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import trainer as tr

    texts, _ = load_text_classification("vendored_reviews", "test",
                                        max_samples=PACK_EXACT_EXAMPLES)

    def on_card(cols):
        return {k: torch.from_numpy(np.asarray(v)).long().to(DEVICE) for k, v in cols.items()}

    rows = {}
    for name, hf in (("causal-lm", GPT2_124M), ("mlm", BERT_BASE)):
        if name == "causal-lm":
            cfg = gpt2_config_from_hf(hf, hidden_dropout=0.0, embd_dropout=0.0,
                                      attention_dropout=0.0, attention_impl="flash")
            model = init_gpt2(cfg, seed=0, device=DEVICE)
            cols = ArrayDataset.from_lm_texts(WordHashTokenizer(hf["vocab_size"]), texts,
                                              GPT2_SEQ).columns
            packed = pack_examples(cols, GPT2_SEQ, causal=True)
            loss_fn = tr.make_fused_causal_lm_loss(model)
        else:
            cfg = auto.CONFIG_BUILDERS["bert"](hf, hidden_dropout=0.0, attention_dropout=0.0,
                                               attention_impl="flash", use_pooler=False)
            model = init_encoder(auto.build_model("bert", "mlm", cfg), seed=0, device=DEVICE)
            seq = min(512, hf["max_position_embeddings"])
            cols = dict(ArrayDataset.from_mlm_texts(WordHashTokenizer(hf["vocab_size"]), texts,
                                                    seq, seed=0, static_masking=True).columns)
            packed = pack_examples(cols, seq)
            loss_fn = tr.make_fused_mlm_loss(0.25)
        for k in _K2:
            getattr(vc, k).launches = 0
        with torch.no_grad():
            _, unpacked_sums = loss_fn(model.eval(), on_card(cols))
            _, packed_sums = loss_fn(model, on_card(packed))
        sums = {k: (float(unpacked_sums[k]), float(packed_sums[k])) for k in unpacked_sums}
        rel = abs(sums["loss_sum"][1] - sums["loss_sum"][0]) / abs(sums["loss_sum"][0])
        row = {"phase": "packing_exactness", "loss": name, "examples": PACK_EXACT_EXAMPLES,
               "rows_unpacked": int(cols["input_ids"].shape[0]),
               "rows_packed": int(packed["input_ids"].shape[0]), "dtype": "float32",
               "sums_unpacked_packed": sums, "loss_sum_rel_err": rel,
               "loss_sum_rtol": PACK_EXACT_RTOL,
               "fused_ce_fwd_launches": vc.fused_ce_fwd.launches}
        emit(row)
        check(rel <= PACK_EXACT_RTOL and sums["count"][0] == sums["count"][1],
              f"packed {name} loss sums differ from unpacked: {sums}")
        check(vc.fused_ce_fwd.launches == 2,
              f"packed {name}: {vc.fused_ce_fwd.launches} fused_ce_fwd launches, wanted 2")
        if name == "mlm":
            check(sums["ce_dropped"] == (0.0, 0.0), f"packed MLM dropped rows: {sums}")
        rows[name] = row
        del model
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return rows


def packing_phase(work: Path, card: str) -> dict:
    """(h) token packing through the training CLI on the vendored reviews at
    sequence 512, batch 8, ``PACK_STEPS`` steps and ``PACK_EVAL_SAMPLES``
    eval examples each: GPT-2 124M ``--task causal-lm --fused_vocab_ce
    true`` unpacked, with ``--segment_packing true`` (the segment mask sends
    every step to the plain attention: no K1 launch) and with
    ``--packed_sequences true`` (all-ones rows: K1 on the eval steps), and
    BERT-base ``--task mlm --segment_packing true --mlm_static_masking true
    --fused_vocab_ce true`` (no K1; ``ce_dropped`` printed); K2's counts
    equal the steps. Each row prints real over padded tokens, samples/s and
    real tokens/s per GPU, MFU, and from ``PACK_PROFILED_STEPS`` more steps
    busy, idle and the K1/K2 device ms. Then (d), the exactness gate
    (:func:`_packing_exactness`). Returns the rows by run."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    phase_t0 = time.perf_counter()
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    restore = _peak_env(peak)
    rows = {}
    rec = _Recorder()
    try:
        with rec:
            for name, hf, task, extra in _packing_runs():
                t0 = time.perf_counter()
                run_dir = work / name
                argv = _slice_argv(_config_dir(run_dir, hf), run_dir, task, PACK_STEPS,
                                   PACK_EVAL_SAMPLES, extra)
                rec.reset()
                results, trainer, launches, wall = _counted_run(argv)
                tc, cfg = trainer.config, trainer.model.config
                steps, L = trainer.step, cfg.num_layers
                eval_steps = _eval_steps(trainer, PACK_EVAL_SAMPLES)
                losses = [float(x) for x in rec.losses]
                check(steps == PACK_STEPS and all(math.isfinite(x) for x in losses),
                      f"{name}: {steps} steps, losses {losses[:3]}")
                segment = tc.segment_packing
                k1_fwd = 0 if segment else L * eval_steps
                want = {"flash_fwd": k1_fwd, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                        "fused_ce_fwd": steps + eval_steps, "fused_ce_bwd_dh": steps,
                        "fused_ce_bwd_dw": steps}
                if task == "mlm":       # the encoder's train steps take K1 unless packed
                    want["flash_fwd"] = 0 if segment else L * (steps + eval_steps)
                check(launches == want, f"{name}: launches {launches}, wanted {want}")
                real = sum(int(x) for x in rec.real)
                padded = sum(rec.padded)
                hist = results["train"]
                sps = hist["train_samples_per_second_per_chip"]
                row = {"phase": "packing", "run": name, "card": card, "task": task,
                       "segment_packing": bool(segment),
                       "packed_sequences": bool(tc.packed_sequences),
                       "layers": L, "seq": tc.max_seq_length, "batch": tc.train_batch_size,
                       "dtype": "bfloat16", "train_steps": steps, "eval_steps": eval_steps,
                       "launches": launches, "first_loss": losses[0], "loss": losses[-1],
                       "eval": results.get("eval", {}),
                       "real_over_padded_tokens": real / padded,
                       "real_tokens_per_row": real / len(rec.padded),
                       "train_samples_per_second_per_chip": sps,
                       "real_tokens_per_second_per_gpu": sps * real / len(rec.padded),
                       "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                       "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall}
                if task == "mlm":
                    row["ce_dropped_train"] = sum(float(x) for x in rec.ce_dropped)
                    check(row["ce_dropped_train"] == 0.0,
                          f"{name}: ce_dropped {row['ce_dropped_train']}")
                # 256 reviews fill about 23 packed rows of 512
                batch, _ = _first_rows(trainer, "train", 8, 256)
                for k in _K1:
                    getattr(fa, k).launches = 0
                row.update(_profiled(trainer, batch, PACK_PROFILED_STEPS, peak, task))
                if segment:
                    check(not any(getattr(fa, k).launches for k in _K1),
                          f"{name}: K1 launched on a profiled packed step")
                if DEVICE == "cuda":
                    check(all(v > 0 for v in row["k2_ms_per_step"].values()),
                          f"{name}: the profile misses a K2 kernel")
                row["run_wall_s"] = time.perf_counter() - t0
                rows[name] = row
                emit(row)
                del trainer
                if DEVICE == "cuda":
                    torch.cuda.empty_cache()
    finally:
        restore()
    exact = _packing_exactness()
    un, seg = rows["gpt2_unpacked"], rows["gpt2_segment"]
    summary = {"phase": "packing_summary", "card": card,
               "phase_wall_s": time.perf_counter() - phase_t0,
               "run_wall_s": {n: r["run_wall_s"] for n, r in rows.items()},
               "real_over_padded": {n: r["real_over_padded_tokens"] for n, r in rows.items()},
               "real_tokens_per_s_per_gpu": {n: r["real_tokens_per_second_per_gpu"]
                                             for n, r in rows.items()},
               "gpt2_segment_over_unpacked_real_tokens_per_s": (
                   seg["real_tokens_per_second_per_gpu"]
                   / un["real_tokens_per_second_per_gpu"]),
               "busy_ms_per_step": {n: r["device_busy_ms_per_step"] for n, r in rows.items()},
               "exactness_rel_err": {n: r["loss_sum_rel_err"] for n, r in exact.items()}}
    emit(summary)
    return rows


LORA_STEPS = 30
# the LoRA and full fine-tune runs' depth at BERT-large's widths: half of
# its 24, to keep the script in its time limit
LORA_DEPTH = 12
LORA_EVAL_SAMPLES = 64          # 16 eval steps at the eval batch of 4
LORA_FULL_STEPS = 5
LORA_CKPT_EVERY = 5
LORA_STOP_AFTER = 8             # the interrupted run stops after step 7
LORA_GPT2_STEPS = 10
LORA_GPT2_EVAL_SAMPLES = 16
LORA_PROFILED_STEPS = 6
LORA_FULL_PROFILED_STEPS = 3


def _opt_bytes(trainer) -> int:
    return sum(v.numel() * v.element_size() for st in trainer.optimizer.state.values()
               for v in st.values() if hasattr(v, "numel") and v.dim() > 0)


def lora_phase(work: Path, card: str) -> dict:
    """(i) LoRA through the training CLI: (a) BERT-large
    (``bert-large-uncased-whole-word-masking`` widths at depth
    ``LORA_DEPTH``) seq-cls at sequence 512, batch 8, ``--lora_rank 8
    --lora_alpha 16``, ``LORA_STEPS`` steps and 16 eval steps: K1's
    forward, dQ and dK/dV once a layer a train step (the forward once a
    layer an eval step), no K2; samples/s,
    busy, idle, MFU, K1's ms per step, the optimizer state's bytes and the
    peak allocated memory. Every base tensor is bit-identical to its seeded
    initial value, only the adapters, classifier and pooler moved, the
    merged export reloads to the live merged model's logits bit for bit,
    the adapter sidecar reloads, and a run stopped after step 7 (checkpoints
    every ``LORA_CKPT_EVERY`` steps, the last at step 5) and resumed equals
    (a)'s losses bit for bit; (b)
    the same model fully fine-tuned for ``LORA_FULL_STEPS`` steps: the same
    memory, step-time and (``LORA_FULL_PROFILED_STEPS`` more steps) busy
    figures; (c) GPT-2 124M LoRA ``--fused_vocab_ce
    true``, ``LORA_GPT2_STEPS`` steps and 4 eval steps: K2's forward and dH
    on every step and no dW (the tied embedding is frozen), K1's forward on
    the eval steps only. Returns the rows by run."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import lora as lo
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops

    phase_t0 = time.perf_counter()
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    restore = _peak_env(peak)
    lora_args = ["--lora_rank", str(LORA_RANK), "--lora_alpha", str(LORA_ALPHA)]
    rows = {}
    rec = _Recorder()
    cfg_dir = _config_dir(work / "bert_large", dict(
        BERT_LARGE, num_hidden_layers=min(LORA_DEPTH, BERT_LARGE["num_hidden_layers"])))

    def peak_reset():
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_bytes():
        return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else "not measured"

    try:
        with rec:
            # (a) LoRA BERT-large, the uninterrupted run of the resume check
            run_dir = work / "bert_large_lora"
            argv = _slice_argv(cfg_dir, run_dir, "seq-cls", LORA_STEPS, LORA_EVAL_SAMPLES,
                               lora_args)
            rec.reset()
            peak_reset()
            results, trainer, launches, wall = _counted_run(argv)
            mem = peak_bytes()
            full_losses = list(rec.losses)
            tc, cfg = trainer.config, trainer.model.config
            L, steps = cfg.num_layers, trainer.step
            eval_steps = _eval_steps(trainer, LORA_EVAL_SAMPLES)
            want = {"flash_fwd": L * (steps + eval_steps), "flash_bwd_dq": L * steps,
                    "flash_bwd_dkv": L * steps, "fused_ce_fwd": 0, "fused_ce_bwd_dh": 0,
                    "fused_ce_bwd_dw": 0}
            check(steps == LORA_STEPS and launches == want,
                  f"lora bert-large: {steps} steps, launches {launches}, wanted {want}")
            check(all(math.isfinite(float(x)) for x in full_losses), "lora: a non-finite loss")
            # the frozen base against its seeded initial value
            init, _, _ = auto.from_pretrained(str(cfg_dir), task="seq-cls", num_labels=2,
                                              dtype=torch.bfloat16, seed=tc.seed,
                                              from_scratch=True, device=DEVICE,
                                              attention_impl="flash")
            paths = lo.jax_param_paths(trainer.model)
            head_rx = re.compile(tc.lora_train_heads)
            live = dict(trainer.model.named_parameters())
            moved = sorted(n for n, p in init.named_parameters()
                           if not torch.equal(p, live[n]))
            check(all(head_rx.search(paths[n]) for n in moved) and moved,
                  f"lora: base tensors moved: {[n for n in moved if not head_rx.search(paths[n])][:4]}")
            heads = sorted(n for n, p in live.items() if p.requires_grad)
            check(all(live[n].grad is None for n in paths if n not in heads),
                  "lora: a frozen base tensor holds a gradient")
            check(all(float(ab["b"].detach().abs().max()) > 0 for ab in trainer.lora.values()),
                  "lora: an adapter's B never moved")
            del init
            # the merged export and the sidecar
            batch, _ = _first_rows(trainer, "test", 4, 16)
            reloaded, _, _ = auto.from_pretrained(str(run_dir / "model"), task="seq-cls",
                                                  dtype=torch.bfloat16, device=DEVICE,
                                                  attention_impl="flash")
            with torch.no_grad():
                a_ = trainer.model.eval()(batch["input_ids"], batch["attention_mask"])
                b_ = reloaded.eval()(batch["input_ids"], batch["attention_mask"])
            check(torch.equal(a_, b_), "lora: the merged export gives other logits")
            del reloaded
            side, side_cfg = lo.load_adapters(str(run_dir / "model" / "adapter"), device=DEVICE)
            check(side_cfg == {"lora_rank": LORA_RANK, "lora_alpha": LORA_ALPHA,
                               "lora_targets": "attention"}
                  and sorted(side) == sorted(trainer.lora)
                  and all(torch.equal(side[p][k], trainer.lora[p][k].detach())
                          for p in side for k in ("a", "b")),
                  f"lora: the sidecar does not reload ({side_cfg})")
            train_batch, _ = _first_rows(trainer, "train", 8, 64)
            prof = _profiled(trainer, train_batch, LORA_PROFILED_STEPS, peak, "seq-cls")
            hist = results["train"]
            row = {"phase": "lora", "run": "bert_large_lora", "card": card,
                   "model": "bert-large-uncased-whole-word-masking widths (random init)",
                   "rank": LORA_RANK, "alpha": LORA_ALPHA, "targets": tc.lora_targets,
                   "layers": L, "seq": 512, "batch": 8, "dtype": "bfloat16",
                   "train_steps": steps, "eval_steps": eval_steps, "launches": launches,
                   "adapter_params": lo.count_params(trainer.lora),
                   "head_params": sum(live[n].numel() for n in heads),
                   "frozen_params": sum(p.numel() for n, p in live.items() if n not in heads),
                   "moved": moved, "optimizer_state_bytes": _opt_bytes(trainer),
                   "max_memory_allocated_bytes": mem,
                   "first_loss": float(full_losses[0]), "loss": float(full_losses[-1]),
                   "eval": results.get("eval", {}),
                   "train_samples_per_second_per_chip":
                       hist["train_samples_per_second_per_chip"],
                   "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                   "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall,
                   "export_reloads_bit_for_bit": True, "sidecar_reloads": True, **prof}
            del trainer
            # the resume: stopped after step 7 (checkpoints every 5 steps),
            # rerun from its step-5 checkpoint to the end of (a)'s steps
            cut_dir = work / "bert_large_lora_cut"
            cut_argv = _slice_argv(cfg_dir, cut_dir, "seq-cls", LORA_STEPS, 0,
                                   lora_args + ["--checkpoint_dir", str(cut_dir / "ckpt"),
                                                "--async_checkpointing", "false",
                                                "--checkpoint_every_steps"])
            rec.reset(stop_after=LORA_STOP_AFTER)
            t0 = time.perf_counter()
            try:
                _counted_run(cut_argv + [str(LORA_CKPT_EVERY)])
                check(False, "lora: the interrupted run was not stopped")
            except _Interrupt:
                pass
            cut_losses = list(rec.losses)
            rec.reset()
            _, resumed, _, _ = _counted_run(cut_argv + ["0"])
            got = torch.stack(list(rec.losses)).float()
            want_l = torch.stack(full_losses[LORA_CKPT_EVERY:]).float()
            check(got.shape == want_l.shape and torch.equal(got, want_l)
                  and torch.equal(torch.stack(cut_losses).float(),
                                  torch.stack(full_losses[:LORA_STOP_AFTER]).float()),
                  f"lora: the resumed losses differ from the uninterrupted run's "
                  f"({got.numel()} against {want_l.numel()})")
            row.update(resume_bit_for_bit=True, resumed_steps=got.numel(),
                       resume_runs_wall_s=time.perf_counter() - t0)
            del resumed
            rows["bert_large_lora"] = row
            emit(row)

            # (b) the same model fully fine-tuned
            run_dir = work / "bert_large_full"
            rec.reset()
            peak_reset()
            results, trainer, launches, wall = _counted_run(
                _slice_argv(cfg_dir, run_dir, "seq-cls", LORA_FULL_STEPS, 0, []))
            hist, full_steps = results["train"], trainer.step
            check(full_steps == LORA_FULL_STEPS, f"full fine-tune: {full_steps} steps")
            full_prof = _profiled(trainer, train_batch, LORA_FULL_PROFILED_STEPS, peak,
                                  "seq-cls")
            full = {"phase": "lora", "run": "bert_large_full_finetune", "card": card,
                    "layers": trainer.model.config.num_layers, "seq": 512, "batch": 8,
                    "dtype": "bfloat16", "train_steps": full_steps, "launches": launches,
                    "trainable_params": sum(p.numel() for p in trainer.params),
                    "optimizer_state_bytes": _opt_bytes(trainer),
                    "max_memory_allocated_bytes": peak_bytes(),
                    "train_samples_per_second_per_chip":
                        hist["train_samples_per_second_per_chip"],
                    "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                    "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall,
                    **full_prof}
            rows["bert_large_full_finetune"] = full
            emit(full)
            del trainer
            peak_reset()

            # (c) GPT-2 LoRA through the fused vocab CE
            run_dir = work / "gpt2_lora"
            rec.reset()
            results, trainer, launches, wall = _counted_run(_slice_argv(
                _config_dir(run_dir, GPT2_124M), run_dir, "causal-lm", LORA_GPT2_STEPS,
                LORA_GPT2_EVAL_SAMPLES, lora_args + ["--fused_vocab_ce", "true"]))
            steps, L = trainer.step, trainer.model.config.num_layers
            eval_steps = _eval_steps(trainer, LORA_GPT2_EVAL_SAMPLES)
            # the tied embedding is frozen (no head regex matches GPT-2), so
            # no step needs dW: the wrapper skips its kernel
            want = {"flash_fwd": L * eval_steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "fused_ce_fwd": steps + eval_steps, "fused_ce_bwd_dh": steps,
                    "fused_ce_bwd_dw": 0}
            check(steps == LORA_GPT2_STEPS and launches == want,
                  f"gpt2 lora: {steps} steps, launches {launches}, wanted {want}")
            check(all(math.isfinite(float(x)) for x in rec.losses), "gpt2 lora: non-finite")
            check(not any(p.requires_grad for p in trainer.model.parameters()),
                  "gpt2 lora: a base weight is trainable (no head matches)")
            hist = results["train"]
            g = {"phase": "lora", "run": "gpt2_lora_fused", "card": card,
                 "layers": L, "seq": 512, "batch": 8, "dtype": "bfloat16",
                 "train_steps": steps, "eval_steps": eval_steps, "launches": launches,
                 "adapter_params": lo.count_params(trainer.lora),
                 "optimizer_state_bytes": _opt_bytes(trainer),
                 "loss": [float(x) for x in rec.losses], "eval": results.get("eval", {}),
                 "train_samples_per_second_per_chip":
                     hist["train_samples_per_second_per_chip"],
                 "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                 "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall}
            rows["gpt2_lora_fused"] = g
            emit(g)
            del trainer
    finally:
        restore()
    a, b = rows["bert_large_lora"], rows["bert_large_full_finetune"]
    emit({"phase": "lora_summary", "card": card,
          "phase_wall_s": time.perf_counter() - phase_t0,
          "lora_over_full_peak_memory": (a["max_memory_allocated_bytes"]
                                         / b["max_memory_allocated_bytes"]
                                         if DEVICE == "cuda" else "not measured"),
          "lora_over_full_optimizer_bytes": a["optimizer_state_bytes"]
          / b["optimizer_state_bytes"],
          "lora_over_full_step_time": a["step_time_ms"] / b["step_time_ms"],
          "lora_over_full_busy": (a["device_busy_ms_per_step"] / b["device_busy_ms_per_step"]
                                  if DEVICE == "cuda" else "not measured"),
          "k1_ms_per_step_lora": a["k1_ms_per_step"]})
    return rows


DEBERTA_STEPS = 20
DEBERTA_EVAL_SAMPLES = 64       # 16 eval steps at the eval batch of 4
DEBERTA_MLM_STEPS = 15
DEBERTA_MLM_EVAL_SAMPLES = 16   # 4 eval steps: K2's eval shape (N 512)
DEBERTA_V2_STEPS = 5
DEBERTA_PROFILED_STEPS = 6
DEBERTA_MLM_PROFILED_STEPS = 3


def _deberta_runs() -> list:
    """(name, config, task, steps, eval examples, CLI arguments)."""
    v2 = dict(DEBERTA_V3_BASE, num_hidden_layers=PARITY_DEPTH, share_att_key=False,
              conv_kernel_size=3, conv_act="gelu", position_biased_input=True)
    return [("v3_base_seq_cls", DEBERTA_V3_BASE, "seq-cls", DEBERTA_STEPS,
             DEBERTA_EVAL_SAMPLES, []),
            ("v3_base_mlm_fused", DEBERTA_V3_BASE, "mlm", DEBERTA_MLM_STEPS,
             DEBERTA_MLM_EVAL_SAMPLES, ["--fused_vocab_ce", "true"]),
            ("v2_style_depth2", v2, "seq-cls", DEBERTA_V2_STEPS, 0, [])]


def deberta_phase(work: Path, card: str) -> dict:
    """(j) DeBERTa through the training CLI with ``microsoft/deberta-v3-base``
    widths from a config.json (random weights, bf16, sequence 512, batch
    8): (a) seq-cls, ``DEBERTA_STEPS`` steps and 16 eval steps, profiled
    (samples/s, busy, idle, MFU); (b) ``--task mlm --fused_vocab_ce true``,
    ``DEBERTA_MLM_STEPS`` steps and 4 eval steps: K2 at V 128100 on every
    step, its kernels' device ms per step from a profile; (c) a v2-style
    config at depth 2 (``share_att_key`` false: the separate position
    projections; ``conv_kernel_size`` 3; absolute positions). No run
    launches K1 (the disentangled attention is the plain one); each export
    reloads to the same logits bit for bit. Returns the rows by run."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops

    phase_t0 = time.perf_counter()
    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    restore = _peak_env(peak)
    rows = {}
    rec = _Recorder()
    try:
        with rec:
            for name, hf, task, n_steps, eval_samples, extra in _deberta_runs():
                t0 = time.perf_counter()
                run_dir = work / name
                rec.reset()
                results, trainer, launches, wall = _counted_run(_slice_argv(
                    _config_dir(run_dir, hf), run_dir, task, n_steps, eval_samples, extra))
                cfg = trainer.model.config
                steps = trainer.step
                eval_steps = _eval_steps(trainer, eval_samples)
                fused = task == "mlm"
                want = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                        "fused_ce_fwd": steps + eval_steps if fused else 0,
                        "fused_ce_bwd_dh": steps if fused else 0,
                        "fused_ce_bwd_dw": steps if fused else 0}
                losses = [float(x) for x in rec.losses]
                check(steps == n_steps and launches == want,
                      f"deberta {name}: {steps} steps, launches {launches}, wanted {want}")
                check(all(math.isfinite(x) for x in losses), f"deberta {name}: non-finite")
                batch, _ = _first_rows(trainer, "test", 4, 16)
                reloaded, fam, _ = auto.from_pretrained(
                    str(run_dir / "model"), task=task, dtype=torch.bfloat16, device=DEVICE)
                with torch.no_grad():
                    a_ = trainer.model.eval()(batch["input_ids"], batch["attention_mask"])
                    b_ = reloaded.eval()(batch["input_ids"], batch["attention_mask"])
                check(fam == "deberta-v2" and torch.equal(a_, b_),
                      f"deberta {name}: the reloaded export gives other logits")
                del reloaded, a_, b_
                hist = results["train"]
                row = {"phase": "deberta", "run": name, "card": card, "task": task,
                       "layers": cfg.num_layers, "hidden": cfg.hidden_size,
                       "vocab": cfg.vocab_size, "share_att_key": cfg.share_att_key,
                       "pos_att_type": list(cfg.pos_att_type),
                       "conv_kernel_size": cfg.conv_kernel_size, "seq": 512, "batch": 8,
                       "dtype": "bfloat16", "train_steps": steps, "eval_steps": eval_steps,
                       "launches": launches, "first_loss": losses[0], "loss": losses[-1],
                       "eval": results.get("eval", {}),
                       "train_samples_per_second_per_chip":
                           hist["train_samples_per_second_per_chip"],
                       "step_time_ms": 1e3 * trainer.meter.avg_step_time,
                       "train_mfu": hist.get("train_mfu", "not measured"),
                       "cli_wall_s": wall, "export_reloads_bit_for_bit": True}
                if fused:
                    row["ce_dropped_train"] = sum(float(x) for x in rec.ce_dropped)
                if name != "v2_style_depth2":
                    train_batch, _ = _first_rows(trainer, "train", 8, 16)
                    row.update(_profiled(trainer, train_batch,
                                         DEBERTA_MLM_PROFILED_STEPS if fused
                                         else DEBERTA_PROFILED_STEPS, peak, task))
                    if DEVICE == "cuda" and fused:
                        check(all(v > 0 for v in row["k2_ms_per_step"].values()),
                              f"deberta {name}: the profile misses a K2 kernel")
                row["run_wall_s"] = time.perf_counter() - t0
                rows[name] = row
                emit(row)
                del trainer
                if DEVICE == "cuda":
                    torch.cuda.empty_cache()
    finally:
        restore()
    emit({"phase": "deberta_summary", "card": card,
          "phase_wall_s": time.perf_counter() - phase_t0,
          "run_wall_s": {n: r["run_wall_s"] for n, r in rows.items()},
          "busy_ms_per_step": {n: r.get("device_busy_ms_per_step") for n, r in rows.items()},
          "mlm_k2_ms_per_step": rows["v3_base_mlm_fused"]["k2_ms_per_step"]})
    return rows


# -- the Llama family and MoE -------------------------------------------------------

# each Hugging Face Hub repo's published config.json widths, written by the
# phase (the card has neither network nor transformers); weights random
# from a seed; depth cut where the comment says
LLAMA_31_8B = {  # meta-llama/Llama-3.1-8B
    "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "max_position_embeddings": 131072,
    "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "rms_norm_eps": 1e-5, "hidden_act": "silu", "tie_word_embeddings": False,
    "bos_token_id": 128000, "eos_token_id": 128001, "initializer_range": 0.02}
MISTRAL_7B = {  # mistralai/Mistral-7B-v0.1 at depth 4 of 32
    "model_type": "mistral", "architectures": ["MistralForCausalLM"], "vocab_size": 32000,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 4,
    "num_attention_heads": 32, "num_key_value_heads": 8, "max_position_embeddings": 32768,
    "rope_theta": 10000.0, "sliding_window": 4096, "rms_norm_eps": 1e-5,
    "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": 2, "initializer_range": 0.02}
TINYLLAMA = {  # TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T, full depth
    "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": 32000,
    "hidden_size": 2048, "intermediate_size": 5632, "num_hidden_layers": 22,
    "num_attention_heads": 32, "num_key_value_heads": 4, "max_position_embeddings": 2048,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "initializer_range": 0.02}
MIXTRAL_8X7B = {  # mistralai/Mixtral-8x7B-v0.1 at depth 1 of 32
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"], "vocab_size": 32000,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 1,
    "num_attention_heads": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768, "rope_theta": 1e6,
    "sliding_window": None, "rms_norm_eps": 1e-5, "router_aux_loss_coef": 0.02,
    "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": 2, "initializer_range": 0.02}
GEMMA_7B = {  # google/gemma-7b, full depth
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "vocab_size": 256000,
    "hidden_size": 3072, "intermediate_size": 24576, "num_hidden_layers": 28,
    "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "hidden_act": "gelu", "attention_bias": False, "bos_token_id": 2, "eos_token_id": 1,
    "pad_token_id": 0, "initializer_range": 0.02}
GEMMA_2B = {  # google/gemma-2b, full depth
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "vocab_size": 256000,
    "hidden_size": 2048, "intermediate_size": 16384, "num_hidden_layers": 18,
    "num_attention_heads": 8, "num_key_value_heads": 1, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "hidden_act": "gelu", "attention_bias": False, "bos_token_id": 2, "eos_token_id": 1,
    "pad_token_id": 0, "initializer_range": 0.02}
# (a) the engine's defaults (K3, prefix cache, ladder, overlap) at 8 slots,
# chunk 32, max_model_len 2048 (an 8-row prefill gathers at most 2 GiB of
# its 128 KiB a token); 8 requests of 128-512 prompt tokens, 32 new each
LLAMA_ENGINE = dict(num_slots=8, block_size=16, prefill_chunk=32, max_model_len=2048)
LLAMA_TRACE = dict(n=8, lo=128, hi=512, new=32)
# (b) one request of 4600 tokens past the window of 4096, 32 new
MISTRAL_ENGINE = dict(num_slots=4, block_size=16, prefill_chunk=32, max_model_len=4736)
MISTRAL_PROMPT, MISTRAL_NEW = 4600, 32
# (c) the train CLI: batch 4 x S 1024 (EOS-joined rows: 2048 reviews fill
# 89, 64 test reviews 3), 12 steps, bf16, AdamW
TINYLLAMA_RUN = dict(batch=4, seq=1024, steps=12, eval_samples=64, train_samples=2048,
                     profiled=3)
# (d) bf16, batch 2 x S 512, 5 steps
MIXTRAL_RUN = dict(batch=2, seq=512, steps=5)
# (e) Gemma-7B on LLAMA_ENGINE (its KV is 448 KiB a token: the pools take
# 7.3 GB); 8 requests of 128-512 prompt tokens, 32 new each
GEMMA_TRACE = dict(n=8, lo=128, hi=512, new=32)
# (f) the train CLI as (c) runs it: batch 2 x S 1024, 8 steps, bf16, AdamW
GEMMA_RUN = dict(batch=2, seq=1024, steps=8, eval_samples=64, train_samples=2048,
                 profiled=3)
# the fp32 gates: kernels (flash + fused CE) against the plain path, the
# first step's loss and gradients, then LLAMA_GATE_STEPS steps' losses
LLAMA_GATE = dict(depth=2, batch=2, seq=512, steps=5, lr=1e-5)
MIXTRAL_GATE = dict(batch=1, seq=512)
# greedy decode against the full forward at a capacity that cannot bind
MIXTRAL_DECODE = dict(prompt=32, new=16, capacity_factor=4.0)
# a bf16 run's tie bound: this many times the plain path's own noise
# (``_plain_agreement``)
BF16_TIE_FACTOR = 2.0


def _mem_reset() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30 if DEVICE == "cuda" \
        else "not measured"


def _random_prompts(vocab: int, n: int, lo: int, hi: int, new: int, seed: int) -> list:
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.randint(3, vocab - 1, (int(rng.randint(lo, hi + 1)),)).astype(np.int32), new)
            for _ in range(n)]


def _teacher_logits(model, trace, outs) -> list:
    """The plain full forward (``model``'s own attention, no cache) of each
    prompt followed by ``outs``' tokens, batched and right-padded: per
    request the fp32 logits ``[len(out), V]`` each of its tokens was
    picked from."""
    import torch

    seqs = [list(p) + list(o[:-1]) for (p, _), o in zip(trace, outs)]
    W = max(len(x) for x in seqs)
    ids = torch.zeros(len(seqs), W, dtype=torch.long)
    mask = torch.zeros(len(seqs), W, dtype=torch.long)
    for i, x in enumerate(seqs):
        ids[i, :len(x)], mask[i, :len(x)] = torch.as_tensor(x, dtype=torch.long), 1
    with torch.inference_mode():
        logits = model(ids.to(DEVICE), mask.to(DEVICE))
    return [logits[i, len(p) - 1:len(p) - 1 + len(o)].float()
            for i, ((p, _), o) in enumerate(zip(trace, outs))]


def _plain_reference(model, trace) -> tuple:
    """The batched plain ``generate_causal`` of every prompt of ``trace``
    (right-padded; dense cache, plain attention, ``model``'s KV storage):
    ``(tokens per request, their logits, the tie bound)``. The bound is
    ``NEAR_TIE`` in fp32; in bf16 ``BF16_TIE_FACTOR`` times the plain path's
    own noise, the largest logit difference between its cached decode and
    its full forward on its own tokens (two orders of the same bf16
    sums)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )

    P = max(len(p) for p, _ in trace)
    T = max(m for _, m in trace)
    ids = torch.zeros(len(trace), P, dtype=torch.long)
    mask = torch.zeros(len(trace), P, dtype=torch.long)
    for i, (p, _) in enumerate(trace):
        ids[i, :len(p)], mask[i, :len(p)] = torch.as_tensor(p, dtype=torch.long), 1
    tok, scores = generate_causal(model, ids.to(DEVICE), mask.to(DEVICE), max_new_tokens=T,
                                  output_scores=True)
    eos = model.config.eos_token_id
    refs = []
    for i, (_, m) in enumerate(trace):
        ref = tok[i, :m].tolist()
        refs.append(ref[:ref.index(eos) + 1] if eos in ref else ref)
    noise = 0.0
    if model.config.dtype != torch.float32:
        for i, full in enumerate(_teacher_logits(model, trace, refs)):
            noise = max(noise, float((full - scores[i, :len(refs[i])]).abs().max()))
    return refs, scores, max(NEAR_TIE, BF16_TIE_FACTOR * noise), noise


def _plain_agreement(model, trace, outs, what: str, reference=None) -> dict:
    """Each request's tokens (``outs``) against the plain reference
    (``reference``, else :func:`_plain_reference` of ``model``): equal up
    to the first step where the plain path's top-2 logit gap is below its
    tie bound ``tau``; then every token of ``outs``, teacher-forced through
    the plain full forward on its own prefix, within ``tau`` of that
    forward's largest logit."""
    import torch

    refs, scores, tau, noise = reference or _plain_reference(model, trace)
    compared = near_ties = 0
    for i, (ref, got) in enumerate(zip(refs, outs)):
        check(bool(torch.isfinite(scores[i, :len(ref)]).all()),
              f"{what}: request {i}: non-finite logits on the plain path")
        top2 = scores[i, :len(ref)].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        n = next((j for j, gp in enumerate(gaps) if gp < tau), len(ref))
        near_ties += n < len(ref)
        check(len(got) == len(ref) or n < len(ref),
              f"{what}: request {i}: {len(got)} tokens, the plain path {len(ref)}")
        if got[:n] != ref[:n]:
            split = next((j for j, (x, y) in enumerate(zip(got, ref)) if x != y),
                         min(len(got), len(ref)))
            check(False, f"{what}: request {i}'s tokens differ from the plain "
                         f"generate_causal at step {split} (top-2 gap "
                         f"{gaps[min(split, len(gaps) - 1)]}) before any near-tie under "
                         f"{tau} ({got[:n]} vs {ref[:n]})")
        compared += n
    deficits, argmax = [], 0
    for o, full in zip(outs, _teacher_logits(model, trace, outs)):
        picked = full.gather(1, torch.as_tensor(o, device=full.device)[:, None])[:, 0]
        deficits += (full.max(-1).values - picked).tolist()
        argmax += int((full.argmax(-1) == torch.as_tensor(o, device=full.device)).sum())
    worst = max(deficits)
    check(worst <= tau, f"{what}: a token sits {worst} below the plain forward's largest "
                        f"logit on its own prefix (tau {tau})")
    return {"tokens_compared_with_plain": compared, "near_ties": near_ties,
            "tie_bound": tau, "plain_self_noise": noise,
            "teacher_forced_tokens": len(deficits), "teacher_forced_argmax": argmax,
            "teacher_forced_max_deficit": worst}


def _k3_serve_runs(served, trace, runs, **row_kw) -> tuple[dict, dict]:
    """Each run of ``runs`` (name, engine arguments) serving ``served`` on
    a fresh engine at
    ``LLAMA_ENGINE``, K3 widths on its ladder; the fp run also the idle
    share over iterations ``OVERLAP_PROFILED`` of a fresh engine. Returns
    (rows, tokens) by run name."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import (
        ServeEngine,
        parse_gather_buckets,
    )

    kw = dict(LLAMA_ENGINE, device=DEVICE, num_blocks=1 + LLAMA_ENGINE["num_slots"]
              * LLAMA_ENGINE["max_model_len"] // LLAMA_ENGINE["block_size"])
    ladder = parse_gather_buckets(None, LLAMA_ENGINE["max_model_len"],
                                  LLAMA_ENGINE["block_size"])
    rows, outs = {}, {}
    for run, extra in runs:
        _mem_reset()
        engine = ServeEngine(served, **kw, **extra)
        o, wall, launches = _engine_run(engine, trace)
        row = _engine_row(engine, run, o, wall, launches, **row_kw,
                          layers=served.config.num_layers, dtype="bfloat16",
                          kv_dtype=engine.kv_cache_dtype, kernel=engine.kernel,
                          kv_bytes_per_token=engine.blocks.token_bytes,
                          k3_launches_per_decode_step=(launches / engine.stats().decode_steps
                                                       if launches else 0),
                          peak_gib=_peak_gib())
        check(set(engine.paged_launches_by_width) <= set(ladder),
              f"{row_kw['phase']} {run}: K3 widths {sorted(engine.paged_launches_by_width)} "
              f"off the ladder {ladder}")
        del engine
        if run == "fp":
            engine = ServeEngine(served, **kw)
            row.update(_idle_window(engine, trace, [{}] * len(trace)))
            del engine
        outs[run] = o
        rows[run] = row
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return rows, outs


def llama_serve_phase(card: str) -> dict:
    """(a) Llama-3.1-8B in bf16 built on the card from seed 0: the trace on
    fp pools, int8 pools and the gather route (``kernel="xla"``), each on
    a fresh engine at ``LLAMA_ENGINE``; K3 once a layer a decode step (none
    on the gather route); each run's tokens held to the batched plain
    ``generate_causal`` (int8: on the int8 dense cache) by
    ``_plain_agreement`` (equal up to a tie under the bf16 tie bound, and
    every token within it of the plain forward's largest logit on its own
    prefix), the gather route's equal to K3's up to such a tie. Rows:
    tokens/s, TTFT, K3 launches by width, KV bytes a token, peak memory;
    the fp run the idle share over iterations ``OVERLAP_PROFILED`` of a
    fresh engine."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        llama_config_from_hf,
    )

    _mem_reset()
    t0 = time.perf_counter()
    cfg = llama_config_from_hf(LLAMA_31_8B, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = init_llama(cfg, seed=0, device=DEVICE)
    _sync()
    init_s = time.perf_counter() - t0
    weights_gib = _peak_gib()
    trace = _random_prompts(cfg.vocab_size, LLAMA_TRACE["n"], LLAMA_TRACE["lo"],
                            LLAMA_TRACE["hi"], LLAMA_TRACE["new"], seed=0)
    rows, outs = _k3_serve_runs(
        model, trace, (("fp", {}), ("int8", {"kv_cache_dtype": "int8"}),
                       ("xla", {"kernel": "xla"})),
        phase="llama_serve", model="meta-llama/Llama-3.1-8B widths (random init, seed 0)",
        card=card)
    reference = _plain_reference(model, trace)
    rows["fp"].update(_plain_agreement(model, trace, outs["fp"], "llama fp pools", reference))
    rows["int8"].update(_plain_agreement(_kv_twin(model, "int8"), trace, outs["int8"],
                                         "llama int8 pools"))
    rows["xla"].update(_plain_agreement(model, trace, outs["xla"], "llama gather route",
                                        reference))
    rows["xla"]["same_tokens_as_k3"] = _same_tokens(
        model, trace, outs["xla"], outs["fp"], "llama gather route against K3",
        tie=rows["fp"]["tie_bound"])
    check(rows["int8"]["kv_bytes_per_token"] < rows["fp"]["kv_bytes_per_token"],
          "int8 pools cost no fewer bytes a token")
    for row in rows.values():
        row.update(init_s=init_s, weights_gib=weights_gib)
        emit(row)
    del model
    return rows


def gemma_serve_phase(card: str) -> dict:
    """(e) Gemma-7B at full depth in bf16 built on the card from seed 3:
    K3 at head_dim 256 with one query head a K/V head (16 over 16), the
    trace ``GEMMA_TRACE`` on fp and int8 pools at ``LLAMA_ENGINE``, each
    run's tokens held to the batched plain ``generate_causal`` by
    ``_plain_agreement``; rows as (a)'s, keyed ``gemma7b_<run>``."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        llama_config_from_hf,
    )

    _mem_reset()
    t0 = time.perf_counter()
    cfg = llama_config_from_hf(GEMMA_7B, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    check(cfg.resolved_head_dim == 256 and cfg.hidden_act == "gelu_pytorch_tanh"
          and cfg.tie_word_embeddings and cfg.rms_unit_offset and cfg.embed_scale,
          f"gemma-7b config read as {cfg}")
    model = init_llama(cfg, seed=3, device=DEVICE)
    _sync()
    init_s = time.perf_counter() - t0
    weights_gib = _peak_gib()
    g = GEMMA_TRACE
    trace = _random_prompts(cfg.vocab_size, g["n"], g["lo"], g["hi"], g["new"], seed=3)
    rows, outs = _k3_serve_runs(
        model, trace, (("fp", {}), ("int8", {"kv_cache_dtype": "int8"})),
        phase="gemma_serve", model="google/gemma-7b widths, full depth (random init, seed 3)",
        card=card, head_dim=cfg.resolved_head_dim,
        params=sum(t.numel() for t in model.parameters()))
    rows["fp"].update(_plain_agreement(model, trace, outs["fp"], "gemma fp pools"))
    rows["int8"].update(_plain_agreement(_kv_twin(model, "int8"), trace, outs["int8"],
                                         "gemma int8 pools"))
    for row in rows.values():
        row.update(init_s=init_s, weights_gib=weights_gib)
        emit(row)
    del model
    return {f"gemma7b_{k}": v for k, v in rows.items()}


def mistral_window_phase(card: str) -> dict:
    """(b) Mistral-7B's widths at depth 4 in bf16 (seed 1): one request of
    ``MISTRAL_PROMPT`` tokens, past its window of 4096, and
    ``MISTRAL_NEW`` new through the engine's K3 route; every K3 call takes
    ``window=4096``, the tokens equal ``generate_causal``'s up to a
    near-tie."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import llama as t_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.serve.engine import ServeEngine

    _mem_reset()
    cfg = t_llama.llama_config_from_hf(MISTRAL_7B, dtype=torch.bfloat16,
                                       param_dtype=torch.bfloat16)
    model = init_llama(cfg, seed=1, device=DEVICE)
    trace = _random_prompts(cfg.vocab_size, 1, MISTRAL_PROMPT, MISTRAL_PROMPT, MISTRAL_NEW,
                            seed=1)
    check(MISTRAL_PROMPT > cfg.sliding_window, "the prompt does not pass the window")
    engine = ServeEngine(model, **MISTRAL_ENGINE, device=DEVICE, num_blocks=1 + (
        MISTRAL_ENGINE["num_slots"] * MISTRAL_ENGINE["max_model_len"]
        // MISTRAL_ENGINE["block_size"]))
    windows = []
    real = t_llama.paged_attention

    def recorded(*args, **kwargs):
        windows.append(kwargs.get("window"))
        return real(*args, **kwargs)

    t_llama.paged_attention = recorded
    try:
        outs, wall, launches = _engine_run(engine, trace)
    finally:
        t_llama.paged_attention = real
    check(set(windows) == {cfg.sliding_window},
          f"K3 took windows {sorted(set(map(str, windows)))}, wanted {cfg.sliding_window}")
    row = _engine_row(engine, "mistral_window", outs, wall, launches, phase="llama_window",
                      model="mistralai/Mistral-7B-v0.1 widths at depth 4 (random init, seed 1)",
                      card=card, layers=cfg.num_layers, dtype="bfloat16",
                      window=cfg.sliding_window, prompt_tokens=MISTRAL_PROMPT,
                      k3_window_calls=len(windows), peak_gib=_peak_gib())
    row.update(_plain_agreement(model, trace, outs, "mistral window"))
    emit(row)
    del engine, model
    return {"mistral_window": row}


def _llama_gate(hf: dict, name: str, batch: dict, steps: int, lr: float) -> dict:
    """fp32 kernels (flash causal attention + the fused vocab CE) against
    the plain path (plain attention, unfused logits and CE) on ``hf``'s
    widths from seed 0: the first step's loss (``PARITY_LOSS_RTOL``) and
    every parameter's gradient (``PARITY_GRAD_REL_L2`` relative L2; a
    parameter whose gradient is 0 holds noise below ``PARITY_KEY_BIAS`` of
    the global norm), the MoE aux loss included, then ``steps`` AdamW
    steps' losses (``PARITY_LOSS_RTOL`` each)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        llama_config_from_hf,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import moe_aux_loss
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    first, curves, ref = {}, {}, None
    for impl in ("xla", "flash"):
        cfg = llama_config_from_hf(hf, attention_impl=impl)
        model = init_llama(cfg, seed=0, device=DEVICE, trainable=True).train()
        trainer = Trainer(TrainConfig(task="causal-lm", dtype="float32", learning_rate=lr,
                                      scale_lr_by_world_size=False, log_every_steps=0,
                                      fused_vocab_ce=impl == "flash",
                                      num_experts=cfg.num_experts), model, total_steps=steps)
        loss, _ = trainer.loss_fn(model, batch)
        aux = moe_aux_loss(model)
        loss = loss if aux is None else loss + aux
        loss.backward()
        first[impl] = float(loss.detach())
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        curves[impl] = [float(trainer.train_step(batch)["loss"]) for _ in range(steps)]
        del model, trainer
        if ref is None:
            ref = grads
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    total = float(torch.sqrt(sum((g.float() ** 2).sum() for g in ref.values())))
    zero = [n for n, g in ref.items() if float(g.norm()) <= PARITY_ZERO_GRAD * total]
    noise = max((float(grads[n].norm()) for n in zero), default=0.0) / total
    rel = {n: float((g - ref[n]).norm() / ref[n].norm())
           for n, g in grads.items() if n not in zero}
    worst = max(rel, key=rel.get)
    rel_loss = abs(first["flash"] - first["xla"]) / abs(first["xla"])
    curve_rel = [abs(a - b) / abs(b) for a, b in zip(curves["flash"], curves["xla"])]
    row = {"phase": "llama_gate", "model": name, "layers": hf["num_hidden_layers"],
           "batch": int(batch["input_ids"].shape[0]), "seq": int(batch["input_ids"].shape[1]),
           "dtype": "float32", "tf32": False,
           "kernels": "flash causal attention + fused vocab CE",
           "plain": "plain attention + unfused logits and CE",
           "loss_kernels": first["flash"], "loss_plain": first["xla"],
           "loss_rel_err": rel_loss, "loss_rtol": PARITY_LOSS_RTOL,
           "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
           "grad_rel_l2_tol": PARITY_GRAD_REL_L2, "params": len(rel),
           "zero_grad_params": zero, "zero_grad_noise_over_global": noise,
           "steps": steps, "learning_rate": lr, "curve_kernels": curves["flash"],
           "curve_plain": curves["xla"], "curve_rel_err_max": max(curve_rel)}
    emit(row)
    check(rel_loss <= PARITY_LOSS_RTOL, f"{name} gate: loss rel err {rel_loss}")
    check(rel[worst] <= PARITY_GRAD_REL_L2, f"{name} gate: {worst} grad rel L2 {rel[worst]}")
    check(noise <= PARITY_KEY_BIAS, f"{name} gate: zero-gradient noise {noise}")
    check(max(curve_rel) <= PARITY_LOSS_RTOL, f"{name} gate: curve rel err {curve_rel}")
    return row


def _causal_cli_phase(work: Path, card: str, name: str, hf: dict, r: dict,
                      label: str) -> dict:
    """``hf``'s widths through the train CLI as ``r`` sizes the run:
    ``--task causal-lm --fused_vocab_ce true --packed_sequences true``,
    bf16, AdamW, batch ``r["batch"]`` x S ``r["seq"]``, ``r["steps"]``
    steps on the vendored reviews; K1 and K2 once a layer / once a step
    (train and eval steps counted), samples/s, MFU, busy and idle share and
    K1/K2 device ms per step over ``r["profiled"]`` more steps, K2's share
    of the busy time, peak memory; then the fp32 gate at depth
    ``LLAMA_GATE["depth"]`` (:func:`_llama_gate`). Returns ``{name: row}``."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs import flops

    peak = flops.peak_tflops(torch.cuda.get_device_name() if DEVICE == "cuda" else None)
    restore = _peak_env(peak)
    run_dir = work / name
    argv = _slice_argv(_config_dir(run_dir, hf), run_dir, "causal-lm", r["steps"],
                       r["eval_samples"],
                       ["--fused_vocab_ce", "true", "--packed_sequences", "true",
                        "--max_seq_length", str(r["seq"]),
                        "--train_batch_size", str(r["batch"]),
                        "--max_train_samples", str(r["train_samples"])])
    _mem_reset()
    try:
        results, trainer, launches, wall = _counted_run(argv)
        peak_mem = _peak_gib()
        tc, cfg = trainer.config, trainer.model.config
        steps, L = trainer.step, cfg.num_layers
        eval_steps = _eval_steps(trainer, r["eval_samples"])
        want = {"flash_fwd": L * (steps + eval_steps), "flash_bwd_dq": L * steps,
                "flash_bwd_dkv": L * steps, "fused_ce_fwd": steps + eval_steps,
                "fused_ce_bwd_dh": steps, "fused_ce_bwd_dw": steps}
        check(steps == r["steps"] and launches == want,
              f"{name}: {steps} steps, launches {launches}, wanted {want}")
        check(cfg.attention_impl == "flash" and cfg.dtype == torch.bfloat16
              and tc.train_batch_size == r["batch"] and tc.max_seq_length == r["seq"],
              f"{name}: the CLI did not run bf16 flash at batch {r['batch']} x {r['seq']}")
        hist = results["train"]
        check(all(math.isfinite(x) for x in hist["loss"]), f"{name}: non-finite loss")
        batch, _ = _first_rows(trainer, "train", r["batch"], r["train_samples"])
        prof = _profiled(trainer, batch, r["profiled"], peak, "causal-lm")
    finally:
        restore()
    busy = prof["device_busy_ms_per_step"]
    k2 = sum(prof["k2_ms_per_step"].values())
    row = {"phase": "llama_train", "run": name, "card": card, "model": label,
           "layers": L, "head_dim": cfg.resolved_head_dim, "dtype": "bfloat16",
           "batch": tc.train_batch_size, "seq": tc.max_seq_length, "optimizer": tc.optimizer,
           "train_steps": steps, "eval_steps": eval_steps, "launches": launches,
           "launches_per_step": {k: v / (steps + (eval_steps if k in ("flash_fwd",
                                                                        "fused_ce_fwd")
                                                   else 0)) for k, v in launches.items()},
           "loss": hist["loss"], "eval": results.get("eval", {}),
           "train_samples_per_second_per_chip": hist["train_samples_per_second_per_chip"],
           "step_time_ms": 1e3 * trainer.meter.avg_step_time,
           "train_mfu": hist.get("train_mfu", "not measured"), "cli_wall_s": wall,
           "peak_gib": peak_mem,
           "k2_route": {k: vocab_kernel_names(k, "bfloat16")[0] for k in _K2},
           "k2_share_of_busy": k2 / busy if isinstance(busy, float) and busy else
           "not measured", **prof}
    emit(row)
    del trainer, batch
    _mem_reset()
    g = LLAMA_GATE
    row["gate"] = _llama_gate(dict(hf, num_hidden_layers=g["depth"]), name,
                              _lm_batch(g["batch"], g["seq"], DEVICE, vocab=hf["vocab_size"]),
                              g["steps"], g["lr"])
    return {name: row}


def tinyllama_train_phase(work: Path, card: str) -> dict:
    """(c) TinyLlama-1.1B at full width and depth through the train CLI
    (:func:`_causal_cli_phase` at ``TINYLLAMA_RUN``)."""
    return _causal_cli_phase(work, card, "tinyllama", TINYLLAMA, TINYLLAMA_RUN,
                             "TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T widths, "
                             "full depth (random init, seed 42)")


def gemma_train_phase(work: Path, card: str) -> dict:
    """(f) Gemma-2B at full width and depth through the train CLI
    (:func:`_causal_cli_phase` at ``GEMMA_RUN``): K1 at head_dim 256 with
    the one K/V head repeated to the 8 query heads, K2 at vocab 256000
    with the tied embedding as W (its dW lands in the embedding); the fp32
    gate at depth 2 runs the fp32 D-256 kernels."""
    return _causal_cli_phase(work, card, "gemma2b", GEMMA_2B, GEMMA_RUN,
                             "google/gemma-2b widths, full depth (random init, seed 42)")


def _routing(model, batch) -> dict:
    """Tokens a MoE block's experts took on ``batch`` (one forward, no
    gradient): each expert's kept assignments and the capacity drops."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.moe import (
        expert_capacity,
        moe_aux_loss,
    )

    block = next(b.moe for b in model.backbone.layers if hasattr(b, "moe"))
    seen = []
    hook = block.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            model(batch["input_ids"], batch["attention_mask"])
            _, combine = block.route(seen[0])
    finally:
        hook.remove()
    moe_aux_loss(model)
    kept = (combine > 0).sum(dim=(0, 1, 3))
    B, S = batch["input_ids"].shape
    cfg = model.config
    return {"tokens_per_expert": kept.tolist(), "assignments": cfg.expert_top_k * B * S,
            "capacity_per_row": expert_capacity(cfg, S),
            "capacity_drops": cfg.expert_top_k * B * S - int(kept.sum())}


def mixtral_phase(card: str) -> dict:
    """(d) Mixtral-8x7B's widths at depth 1: 5 bf16 AdamW steps at batch 2
    x S 512 (fp32 weights) through K1 and K2 with the aux loss (K1 and K2
    once a layer / once a step), step time, peak memory, tokens per
    expert and capacity drops; the fp32 gate at batch 1; greedy
    ``generate_causal`` of 16 tokens equal to the full forward's argmax a
    token at a time (up to a near-tie) at a capacity that cannot bind."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import init_llama
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.generate import (
        generate_causal,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.llama import (
        llama_config_from_hf,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import vocab_ce as vc
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    r = MIXTRAL_RUN
    vocab = MIXTRAL_8X7B["vocab_size"]
    _mem_reset()
    cfg = llama_config_from_hf(MIXTRAL_8X7B, dtype=torch.bfloat16, attention_impl="flash")
    model = init_llama(cfg, seed=0, device=DEVICE, trainable=True).train()
    trainer = Trainer(TrainConfig(task="causal-lm", dtype="bfloat16", fused_vocab_ce=True,
                                  num_experts=cfg.num_experts, learning_rate=1e-4,
                                  scale_lr_by_world_size=False, log_every_steps=0),
                      model, total_steps=r["steps"])
    batch = _lm_batch(r["batch"], r["seq"], DEVICE, vocab=vocab)
    counters = [(fa, k) for k in _K1] + [(vc, k) for k in _K2]
    for mod, k in counters:
        getattr(mod, k).launches = 0
    _sync()
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch)["loss"] for _ in range(r["steps"])]
    _sync()
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, k).launches for mod, k in counters}
    losses = [float(x) for x in losses]
    L = cfg.num_layers
    want = {**{k: L * r["steps"] for k in _K1}, **{k: r["steps"] for k in _K2}}
    check(launches == want, f"mixtral: launches {launches}, wanted {want}")
    check(all(math.isfinite(x) for x in losses), f"mixtral: losses {losses}")
    row = {"phase": "llama_moe", "run": "mixtral", "card": card,
           "model": "mistralai/Mixtral-8x7B-v0.1 widths at depth 1 (random init, seed 0)",
           "layers": L, "experts": cfg.num_experts, "top_k": cfg.expert_top_k,
           "capacity_factor": cfg.expert_capacity_factor, "dtype": "bfloat16",
           "batch": r["batch"], "seq": r["seq"], "steps": r["steps"], "losses": losses,
           "launches": launches, "step_time_ms": 1e3 * wall / r["steps"],
           "peak_gib": _peak_gib(), **_routing(model, batch)}
    emit(row)
    del trainer, model
    _mem_reset()
    g = MIXTRAL_GATE
    row["gate"] = _llama_gate(MIXTRAL_8X7B, "mixtral", _lm_batch(g["batch"], g["seq"], DEVICE,
                                                                 vocab=vocab),
                              LLAMA_GATE["steps"], LLAMA_GATE["lr"])
    _mem_reset()
    d = MIXTRAL_DECODE
    cfg = llama_config_from_hf(MIXTRAL_8X7B, expert_capacity_factor=d["capacity_factor"])
    model = init_llama(cfg, seed=0, device=DEVICE)
    (prompt, _), = _random_prompts(vocab, 1, d["prompt"], d["prompt"], d["new"], seed=2)
    cur = torch.as_tensor(prompt, dtype=torch.long, device=DEVICE)[None]
    got = generate_causal(model, cur, max_new_tokens=d["new"])[0].tolist()
    compared = d["new"]
    with torch.no_grad():
        for j in range(d["new"]):
            logits = model(cur)[0, -1].float()
            top2 = logits.topk(2).values
            if float(top2[0] - top2[1]) < NEAR_TIE:
                compared = j
                break
            nxt = int(logits.argmax())
            check(got[j] == nxt, f"mixtral decode: token {j} is {got[j]}, the full "
                                 f"forward's argmax {nxt}")
            cur = torch.cat([cur, cur.new_tensor([[nxt]])], dim=1)
    row["decode"] = {"new_tokens": d["new"], "compared_with_full_forward": compared,
                     "capacity_factor": d["capacity_factor"]}
    emit({"phase": "llama_moe_decode", **row["decode"]})
    del model
    return {"mixtral": row}


# -- the job as the source system launches it --------------------------------

LAUNCH_STEPS = 30               # the launched BERT-large-WWM run's train steps
LAUNCH_EVAL_SAMPLES = 64        # 16 eval steps at the eval batch of 4
LAUNCH_SINGLE_NODE_STEPS = 2    # the single-node entry's run
LAUNCH_SINGLE_NODE_EVAL = 8
LAUNCH_TIMEOUT_S = 420
OPTIM_WEIGHT_DECAY = 0.01
# (run, TrainConfig overrides, remat policy or None): BERT-large-WWM seq-cls
# at sequence 512, batch 8, bf16, in one process
OPTIM_RUNS = (
    ("adamw_fp32", dict(optimizer="adamw"), None),
    ("adamw_bf16_moments", dict(optimizer="adamw", optimizer_state_dtype="bfloat16"), None),
    ("lamb", dict(optimizer="lamb"), None),
    ("remat_full", dict(optimizer="adamw"), "full"),
    ("remat_dots", dict(optimizer="adamw"), "dots"),
    ("remat_dots_no_batch", dict(optimizer="adamw"), "dots_no_batch"),
)
OPTIM_TIMED_STEPS = 5           # after the first (excluded) step, unprofiled
OPTIM_PROFILED_STEPS = 4        # then profiled: 10 steps a run
OPTIM_LOSS_RTOL = 1e-6          # the first step's loss across the runs
OPTIM_PARITY_STEPS = 3          # card against CPU, LAMB and bf16-moment AdamW
OPTIM_PARITY_RTOL = 1e-5
OPTIM_PARITY_LR = 5e-5
RESUME_STEPS = 6                # straight; or half, save, restore, half
RESUME_SEQ = 128


def _start_launch(work: Path, name: str, args: list) -> dict:
    """Start ``python -m <port>.launch`` with ``args`` on this machine's
    first card (``h100-1``; ``cpu-1`` when the script runs on the CPU), as a
    user calls it; its output goes to ``<work>/<name>.out``."""
    root = work / name
    root.mkdir(parents=True, exist_ok=True)
    slice_spec = "h100-1" if DEVICE == "cuda" else "cpu-1"
    sys.stdout.flush()
    with open(work / f"{name}.out", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.launch", "--slice", slice_spec,
             "--job_root", str(root), "--base_job_name", name,
             "--timeout", str(LAUNCH_TIMEOUT_S - 30)] + args,
            cwd=str(ROOT), stdout=out, stderr=subprocess.STDOUT)
    return {"name": name, "proc": proc, "t0": time.perf_counter(), "root": root,
            "out": work / f"{name}.out", "slice": slice_spec}


def _finish_launch(job: dict) -> dict:
    """Wait for a :func:`_start_launch` job (the launcher ends its own
    processes past its ``--timeout``): the job directory, its wall seconds
    and its rank 0 log."""
    name, proc = job["name"], job["proc"]
    try:
        rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    wall = time.perf_counter() - job["t0"]
    printed = job["out"].read_text()
    dirs = sorted(job["root"].iterdir())
    log = (dirs[0] / "host_0.log").read_text() if dirs else ""
    check(rc == 0 and len(dirs) == 1,
          f"launch {name}: rc {rc}, {len(dirs)} job dirs; {printed[-2000:]}{log[-3000:]}")
    check(f"artifacts in {dirs[0]}" in printed, f"launch {name}: {printed[-500:]}")
    return {"job_dir": dirs[0], "wall_s": wall, "log": log, "slice": job["slice"]}


def _read_numbers(path: Path) -> dict:
    """A ``key = value`` results file with each value read as a number or
    a list of numbers."""
    import ast

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.utils.results import (
        read_results_file,
    )

    return {k: ast.literal_eval(v) for k, v in read_results_file(str(path)).items()}


def _finite(value) -> bool:
    values = value if isinstance(value, list) else [value]
    return all(isinstance(v, (int, float)) and math.isfinite(v) for v in values)


def _child_launches(job_dir: Path) -> dict:
    """The K1 and K2 launch counts the launched process wrote as telemetry
    metrics (``kernel_launches/<wrapper>``, ``train/cli.py``)."""
    events = [json.loads(line) for line in
              (job_dir / "output" / "telemetry" / "events.jsonl").read_text().splitlines()]
    return {e["name"].split("/", 1)[1]: int(e["value"]) for e in events
            if e["type"] == "metric" and e["name"].startswith("kernel_launches/")}


def launch_phase(work: Path, card: str) -> dict:
    """(a) The reference's job through the port's launcher: ``python -m
    <port>.launch --slice h100-1`` with the reference's hyperparameters
    (``bert-large-uncased-whole-word-masking`` widths, 24 layers at full
    depth, random weights from a config; train batch 8, eval batch 4, lr
    5e-5, 1 epoch) on the vendored reviews at sequence 512, bf16,
    ``LAUNCH_STEPS`` steps and 16 eval steps. It fails unless the job
    directory holds ``host_0.log``, the results files with the CLI's keys
    and an HF export that loads back and classifies; the child trained on
    the card; and the child's K1 counts (its telemetry) are layers x steps
    (the forward also once a layer an eval step). Beside it the
    single-node entry (``train.single_node``) as a job's entry point, at
    BERT-large widths and depth 2, which must run with the learning rate
    unscaled."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto

    cfg_dir = _config_dir(work / "config", BERT_LARGE)
    layers = BERT_LARGE["num_hidden_layers"]
    # the single-node check needs no full depth (BERT-large widths at 2
    # layers); it starts beside the main job and is through its steps while
    # the main job still draws its weights
    single_layers = 2
    single_cfg = _config_dir(work / "single_config",
                             dict(BERT_LARGE, num_hidden_layers=single_layers))
    started = [_start_launch(work, "launch-bert-large-wwm", [
        "--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
        "--dataset", "vendored_reviews", "--steps_per_epoch", str(LAUNCH_STEPS),
        "--max_train_samples", str(LAUNCH_STEPS * 8),
        "--max_eval_samples", str(LAUNCH_EVAL_SAMPLES), "--log_every_steps", "10"]),
        _start_launch(work, "launch-single-node", [
            "--entry_point", f"{PKG}.train.single_node",
            "--model_name_or_path", str(single_cfg), "--from_scratch", "true",
            "--dataset", "vendored_reviews",
            "--steps_per_epoch", str(LAUNCH_SINGLE_NODE_STEPS),
            "--max_train_samples", str(LAUNCH_SINGLE_NODE_STEPS * 8),
            "--max_eval_samples", str(LAUNCH_SINGLE_NODE_EVAL)])]
    job, single = [_finish_launch(j) for j in started]
    job_dir, log = job["job_dir"], job["log"]
    check(f"rank 0/1 on {DEVICE}" in log, f"launch: the child did not train on {DEVICE}")
    out = job_dir / "output"
    train = _read_numbers(out / "train_results.txt")
    evals = _read_numbers(out / "eval_results.txt")
    # the train phase's keys first; a script run's telemetry adds the MFU
    # figures after them
    check(list(train)[:len(TRAIN_RESULT_KEYS)] == TRAIN_RESULT_KEYS
          and list(evals) == EVAL_RESULT_KEYS,
          f"launch: results keys {list(train)} {list(evals)}")
    check(all(_finite(v) for v in list(train.values()) + list(evals.values())),
          f"launch: results {train} {evals}")
    eval_steps = math.ceil(LAUNCH_EVAL_SAMPLES / 4)
    launches = _child_launches(job_dir)
    want = {"flash_fwd": layers * (LAUNCH_STEPS + eval_steps),
            "flash_bwd_dq": layers * LAUNCH_STEPS, "flash_bwd_dkv": layers * LAUNCH_STEPS}
    if DEVICE == "cuda":
        for k, n in want.items():
            check(launches.get(k) == n, f"launch: the child launched {k} "
                                        f"{launches.get(k)} times, want {n}")
    model, family, cfg = auto.from_pretrained(str(job_dir / "model"), task="seq-cls",
                                              device=DEVICE)
    check(family == "bert" and cfg.num_layers == layers and cfg.hidden_size
          == BERT_LARGE["hidden_size"], f"launch: the export is {family} {cfg}")
    batch = _review_batch(4, 512, DEVICE, split="test", vocab=BERT_LARGE["vocab_size"])
    with torch.no_grad():
        logits = model(batch["input_ids"], batch["attention_mask"])
    check(tuple(logits.shape) == (4, 2) and bool(torch.isfinite(logits.float()).all()),
          f"launch: the reloaded export's logits {tuple(logits.shape)}")
    del model
    row = {"phase": "launch", "card": card, "slice": job["slice"], "model": "bert-large-wwm",
           "layers": layers, "batch": 8, "seq": 512, "dtype": "bfloat16",
           "steps": LAUNCH_STEPS, "eval_steps": eval_steps,
           "job_wall_s": job["wall_s"], "train_runtime_s": train["train_runtime"],
           "samples_per_sec": train["train_samples_per_second"],
           "loss": train["loss"], "eval_loss": evals["eval_loss"],
           "eval_accuracy": evals["eval_accuracy"], "mfu": train.get("train_mfu"),
           "results_keys": list(train) + list(evals), "launches": launches,
           "job_files": sorted(p.name for p in job_dir.iterdir()),
           "telemetry": str(out / "telemetry")}
    emit(row)

    check('"scale_lr_by_world_size": false' in single["log"]
          and f"rank 0/1 on {DEVICE}" in single["log"],
          "launch: the single-node entry did not turn the world-size lr scaling off")
    single_launches = _child_launches(single["job_dir"])
    if DEVICE == "cuda":
        n = single_layers * (LAUNCH_SINGLE_NODE_STEPS
                             + math.ceil(LAUNCH_SINGLE_NODE_EVAL / 4))
        check(single_launches.get("flash_fwd") == n,
              f"launch: single-node flash_fwd {single_launches.get('flash_fwd')}, want {n}")
    srow = {"phase": "launch_single_node", "entry_point": f"{PKG}.train.single_node",
            "layers": single_layers, "steps": LAUNCH_SINGLE_NODE_STEPS,
            "scale_lr_by_world_size": False, "job_wall_s": single["wall_s"],
            "launches": single_launches}
    emit(srow)
    return {"bert_large_wwm": row, "single_node": srow}


def _bert_large_state(seed: int = 0) -> dict:
    """BERT-large-WWM seq-cls weights drawn on the device from ``seed``:
    zero biases, unit layer-norm scales, the rest normal(0, 0.02). Every
    run of the phase starts from a copy; drawn on the card, the 335M
    values cost no host time (``init_encoder`` draws on the CPU)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto

    cfg = auto.CONFIG_BUILDERS["bert"](BERT_LARGE)
    with torch.device("meta"):
        model = auto.build_model("bert", "seq-cls", cfg)
    model = model.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif re.search(r"(^|\.)\w*_ln\.weight$", name):
                p.fill_(1.0)
            else:
                p.normal_(0.0, cfg.initializer_range, generator=gen)
    return model.state_dict()


def _optim_model(state: dict, remat_policy):
    """BERT-large-WWM seq-cls built on the meta device and given a copy of
    ``state``: bf16 compute, the flash kernels on the card, remat under
    ``remat_policy`` (None: no remat)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto

    cfg = auto.CONFIG_BUILDERS["bert"](
        BERT_LARGE, dtype=torch.bfloat16, attention_impl="flash",
        remat=remat_policy is not None, remat_policy=remat_policy or "full")
    with torch.device("meta"):
        model = auto.build_model("bert", "seq-cls", cfg)
    model.load_state_dict({k: v.clone() for k, v in state.items()}, assign=True)
    return model.train()


def _moment_bytes(trainer) -> int:
    return sum(st[k].numel() * st[k].element_size() for st in trainer.optimizer.state.values()
               for k in ("exp_avg", "exp_avg_sq") if k in st)


def _flash_counts() -> dict:
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    return {k: getattr(fa, k).launches for k in _K1}


def _optim_run(name: str, over: dict, policy, state: dict, batch: dict) -> dict:
    """One run of ``OPTIM_RUNS``: the first step (its loss; excluded from
    the times), ``OPTIM_TIMED_STEPS`` timed steps (step ms, samples/s, K1
    launches a step, the peak memory of the steps and of their forward and
    backward alone), then ``OPTIM_PROFILED_STEPS`` profiled (busy a step,
    the idle share, the optimizer's and LAMB's norm kernels' device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    gc.collect()
    _mem_reset()
    model = _optim_model(state, policy)
    tc = TrainConfig(learning_rate=5e-5, scale_lr_by_world_size=False, log_every_steps=0,
                     weight_decay=OPTIM_WEIGHT_DECAY, remat=policy is not None,
                     remat_policy=policy or "full", **over)
    trainer = Trainer(tc, model)
    # each step's peaks: the statistics reset as its forward starts, read as
    # the optimizer starts (the forward and backward's own) and as it ends
    # (the whole step's)
    fwd_bwd_peaks, step_peaks = [], []
    if DEVICE == "cuda":
        model.register_forward_pre_hook(lambda *_: torch.cuda.reset_peak_memory_stats())
        trainer.optimizer.register_step_pre_hook(
            lambda *_: fwd_bwd_peaks.append(torch.cuda.max_memory_allocated()))
        trainer.optimizer.register_step_post_hook(
            lambda *_: step_peaks.append(torch.cuda.max_memory_allocated()))
    torch.manual_seed(0)
    first_loss = float(trainer.train_step(batch)["loss"])
    _sync()
    fwd_bwd_peaks.clear()
    step_peaks.clear()
    before = _flash_counts()
    t0 = time.perf_counter()
    for _ in range(OPTIM_TIMED_STEPS):
        trainer.train_step(batch)
    _sync()
    wall = time.perf_counter() - t0
    after = _flash_counts()
    with profile(activities=[ProfilerActivity.CUDA if DEVICE == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        for _ in range(OPTIM_PROFILED_STEPS):
            trainer.train_step(batch)
        _sync()
    by_kernel = _device_seconds_by_kernel(prof)
    busy = sum(by_kernel.values()) / OPTIM_PROFILED_STEPS
    step_s = wall / OPTIM_TIMED_STEPS

    def kernel_ms(*words):
        return sum(v for k, v in by_kernel.items() if any(w in k for w in words)) \
            / OPTIM_PROFILED_STEPS * 1e3

    row = {"phase": "optim_memory", "run": name, "optimizer": tc.optimizer,
           "optimizer_state_dtype": tc.optimizer_state_dtype, "remat_policy": policy,
           "first_step_loss": first_loss,
           "peak_gib": max(step_peaks) / 2 ** 30 if step_peaks else "not measured",
           "fwd_bwd_peak_gib": (max(fwd_bwd_peaks) / 2 ** 30 if fwd_bwd_peaks
                                else "not measured"),
           "optimizer_state_bytes": _opt_bytes(trainer), "moment_bytes": _moment_bytes(trainer),
           "moment_dtype": str(next(iter(trainer.optimizer.state.values()))["exp_avg"].dtype),
           "step_ms": step_s * 1e3, "samples_per_sec": 8 / step_s,
           "device_busy_ms_per_step": busy * 1e3 if busy else "not measured",
           "idle_share": 1.0 - busy / step_s if busy else "not measured",
           "optimizer_kernels_ms_per_step": kernel_ms("multi_tensor_apply", "foreach"),
           "foreach_norm_ms_per_step": kernel_ms("LpNormFunctor", "lpnorm_cleanup"),
           "k1_launches_per_step": {k: (after[k] - before[k]) / OPTIM_TIMED_STEPS
                                    for k in _K1},
           "top_kernels_ms_per_step": [[k[:80], 1e3 * v / OPTIM_PROFILED_STEPS] for k, v in
                                       sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]]}
    emit(row)
    del trainer, model, prof
    gc.collect()
    return row


def optim_memory_phase() -> dict:
    """(b) The optimizers and the remat policies on BERT-large-WWM seq-cls
    at sequence 512, batch 8, bf16, one batch of training reviews, every
    run from the same weights (``OPTIM_RUNS``: AdamW with fp32 moments and
    no remat, AdamW with bf16 moments, LAMB, AdamW under remat ``full``,
    ``dots`` and ``dots_no_batch``; weight decay 0.01), in a process of its
    own (it profiles). It fails unless the bf16 moments take exactly half
    the fp32 moments' bytes; the peak of the forward and backward is
    ordered none > dots >= dots_no_batch > full; K1's forward launches
    twice a layer a step under each policy (the recompute runs it again:
    no policy can save an ``autograd.Function``'s ctypes launch), its dQ
    and dK/dV once; and the first step's loss is the same in every run."""
    import torch

    state = _bert_large_state()
    batch = _review_batch(8, 512, DEVICE, vocab=BERT_LARGE["vocab_size"])
    rows = {}
    for name, over, policy in OPTIM_RUNS:
        rows[name] = _optim_run(name, over, policy, state, batch)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    base, low = rows["adamw_fp32"], rows["adamw_bf16_moments"]
    check(low["moment_dtype"] == "torch.bfloat16"
          and 2 * low["moment_bytes"] == base["moment_bytes"],
          f"optim_memory: bf16 moments {low['moment_bytes']} B against fp32 "
          f"{base['moment_bytes']} B")
    losses = {n: r["first_step_loss"] for n, r in rows.items()}
    spread = max(abs(v - base["first_step_loss"]) for v in losses.values())
    check(spread <= OPTIM_LOSS_RTOL * abs(base["first_step_loss"]),
          f"optim_memory: first-step losses differ: {losses}")
    layers = BERT_LARGE["num_hidden_layers"]
    if DEVICE == "cuda":
        peaks = [rows[n]["fwd_bwd_peak_gib"] for n in
                 ("adamw_fp32", "remat_dots", "remat_dots_no_batch", "remat_full")]
        check(peaks[0] > peaks[1] >= peaks[2] > peaks[3],
              f"optim_memory: forward/backward peaks none, dots, dots_no_batch, full {peaks}")
    for name, r in rows.items():
        want = {"flash_fwd": layers * (2 if r["remat_policy"] else 1),
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
        check(r["k1_launches_per_step"] == want,
              f"optim_memory {name}: K1 a step {r['k1_launches_per_step']}, want {want}")
    emit({"phase": "optim_memory_summary", "first_step_losses": losses,
          "first_step_losses_bitwise_equal": len(set(losses.values())) == 1,
          "moment_bytes": {n: r["moment_bytes"] for n, r in rows.items()},
          "fwd_bwd_peak_gib": {n: r["fwd_bwd_peak_gib"] for n, r in rows.items()},
          "peak_gib": {n: r["peak_gib"] for n, r in rows.items()}})
    return rows


def _rel_max(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else float((got - want).abs().max())


def optim_parity_phase() -> dict:
    """(c) fp32 parity of the new optimizers and of the remat policies on
    the card. BERT-base widths at depth 2, fp32 (TF32 off), dropout 0.1:
    the gradients of three training batches taken on the card, then
    ``OPTIM_PARITY_STEPS`` steps of LAMB and of bf16-moment AdamW on the
    card's parameters and on CPU copies of the same parameters and
    gradients: every parameter within ``OPTIM_PARITY_RTOL`` of its tensor's
    largest entry (with bf16 moments plus the bound of a moment rounded to
    its neighbouring bf16 value, 2^-5 lr a step: a zero-initialized bias is
    nothing but its updates), fp32 moments within 8 fp32 ulps and bf16
    moments within one bf16 ulp of the CPU's. Then one train step under each remat
    policy against the step without remat (the same seed, so the same
    dropout masks): the loss within 1e-5 relative and every gradient within
    1e-3 relative L2 (the key biases, whose exact gradient is 0, within
    ``PARITY_KEY_BIAS`` of the global norm)."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import optim
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import (
        seq_cls_loss,
    )

    def model(policy=None):
        cfg = auto.CONFIG_BUILDERS["bert"](BERT_BASE, num_layers=PARITY_DEPTH,
                                           attention_impl="flash", remat=policy is not None,
                                           remat_policy=policy or "full")
        return init_encoder(auto.build_model("bert", "seq-cls", cfg), seed=0,
                            device=DEVICE).train()

    batches = [_review_batch(8 * (i + 1), 512, DEVICE) for i in range(OPTIM_PARITY_STEPS)]
    batches = [{k: v[-8:] for k, v in b.items()} for b in batches]
    m = model()
    grads = []
    for b in batches:
        m.zero_grad(set_to_none=True)
        seq_cls_loss(m, b)[0].backward()
        grads.append([p.grad.detach().clone() for p in m.parameters()])
    p0 = [p.detach().clone() for p in m.parameters()]
    rows = {}
    for name, over in (("lamb", dict(optimizer="lamb", weight_decay=OPTIM_WEIGHT_DECAY)),
                       ("adamw_bf16_moments", dict(optimizer="adamw",
                                                   weight_decay=OPTIM_WEIGHT_DECAY,
                                                   optimizer_state_dtype="bfloat16"))):
        tc = TrainConfig(learning_rate=OPTIM_PARITY_LR, scale_lr_by_world_size=False, **over)
        out = []
        for where in (DEVICE, "cpu"):
            ps = [torch.nn.Parameter(p.to(where, copy=True)) for p in p0]
            opt = optim.build_optimizer(tc, ps)[0]
            for g in grads:
                for p, gi in zip(ps, g):
                    p.grad = gi.to(where, copy=True)
                opt.step()
            out.append((ps, opt))
        (dev_ps, dev_opt), (cpu_ps, cpu_opt) = out
        low = "bf16" in name
        # a stored bf16 moment may round to the neighbouring value on the
        # card (its fp32 sum one ulp apart, fused multiply-adds): that
        # moves the update by at most 2^-7 of m plus 2^-8 through sqrt(v),
        # of an Adam update at most 2 in size; each step's share of lr is
        # allowed on top of the relative limit, and the moments are held
        # within one bf16 ulp of the CPU's
        allow = 2.0 ** -5 * OPTIM_PARITY_LR * OPTIM_PARITY_STEPS if low else 0.0
        errs, over = [], []
        for a, b in zip(dev_ps, cpu_ps):
            a, b = a.detach().cpu(), b.detach()
            errs.append(_rel_max(a, b))
            excess = float((a - b).abs().max()) - OPTIM_PARITY_RTOL * float(b.abs().max())
            over.append(excess - allow)
        flips, ulp_ok = 0, True
        for pa, pb in zip(dev_ps, cpu_ps):
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = dev_opt.state[pa][k].cpu().float(), cpu_opt.state[pb][k].float()
                flips += int((a != b).sum())
                ulp = torch.where(b != 0, 2.0 ** (torch.floor(torch.log2(b.abs())) - 7),
                                  torch.zeros_like(b))
                ulp_ok &= bool(((a - b).abs() <= ulp * (1.0 if low else 2.0 ** -13)).all())
        dtypes = {str(st["exp_avg"].dtype) for st in dev_opt.state.values()}
        row = {"phase": "optim_parity", "optimizer": name, "steps": OPTIM_PARITY_STEPS,
               "lr": OPTIM_PARITY_LR, "params": len(errs), "param_rel_err_max": max(errs),
               "rtol": OPTIM_PARITY_RTOL, "rounding_allowance": allow,
               "moment_elements_differing": flips, "moments_within_limit": ulp_ok,
               "moment_dtypes": sorted(dtypes)}
        emit(row)
        check(max(over) <= 0.0, f"optim parity ({name}): card against CPU {max(errs)} "
                                f"(beyond the limit by {max(over)})")
        check(ulp_ok, f"optim parity ({name}): a moment beyond its limit of the CPU's")
        check(dtypes == {"torch.bfloat16" if low else "torch.float32"},
              f"optim parity ({name}): moment dtypes {dtypes}")
        rows[name] = row
    del m

    def step(policy):
        mm = model(policy)
        torch.manual_seed(5)
        loss = seq_cls_loss(mm, batches[0])[0]
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in mm.named_parameters()}

    loss_ref, ref = step(None)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in ref.values())))
    for policy in ("full", "dots", "dots_no_batch"):
        loss, g = step(policy)
        key_bias = [n for n in g if n.endswith("key.bias")]
        noise = max(float((g[n] - ref[n]).norm()) for n in key_bias) / total
        rel = {n: float((v - ref[n]).norm() / ref[n].norm()) for n, v in g.items()
               if n not in key_bias}
        worst = max(rel, key=rel.get)
        row = {"phase": "optim_parity", "remat_policy": policy,
               "loss_rel_err": abs(loss - loss_ref) / abs(loss_ref),
               "grad_rel_l2_max": rel[worst], "grad_rel_l2_worst_param": worst,
               "key_bias_noise_over_global": noise}
        emit(row)
        check(row["loss_rel_err"] <= PARITY_LOSS_RTOL,
              f"remat {policy}: loss rel err {row['loss_rel_err']}")
        check(rel[worst] <= PARITY_GRAD_REL_L2, f"remat {policy}: {worst} rel L2 {rel[worst]}")
        check(noise <= PARITY_KEY_BIAS, f"remat {policy}: key-bias noise {noise}")
        rows[f"remat_{policy}"] = row
    return rows


def optim_resume_phase(work: Path) -> dict:
    """(d) A bitwise resume with the new optimizer state: DistilBERT-base
    widths (no token-type table: its one row sums every token's gradient
    in no fixed order on the card) at depth 2, bf16 compute, the flash
    kernels, dropout 0.1, ``RESUME_STEPS`` training batches of 8 at
    sequence ``RESUME_SEQ``; for LAMB and for bf16-moment AdamW, the steps
    straight against half of them, a save through the ``Checkpointer``, a
    restore into a fresh trainer and the other half. It fails unless every
    loss, parameter and moment is equal bit for bit, the moments in their
    own dtype."""
    import torch

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import auto
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models.convert import (
        init_encoder,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.checkpoint import (
        Checkpointer,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train.trainer import Trainer

    cfg = auto.CONFIG_BUILDERS["distilbert"](
        DISTILBERT_BASE, num_layers=PARITY_DEPTH, dtype=torch.bfloat16, attention_impl="flash")
    texts = _review_batch(8 * RESUME_STEPS, RESUME_SEQ, DEVICE,
                          vocab=DISTILBERT_BASE["vocab_size"])
    batches = [{k: v[8 * i:8 * (i + 1)] for k, v in texts.items()}
               for i in range(RESUME_STEPS)]
    half = RESUME_STEPS // 2
    rows = {}
    for name, over in (("lamb", dict(optimizer="lamb")),
                       ("adamw_bf16_moments", dict(optimizer="adamw",
                                                   optimizer_state_dtype="bfloat16"))):
        tc = TrainConfig(learning_rate=1e-4, scale_lr_by_world_size=False, log_every_steps=0,
                         weight_decay=OPTIM_WEIGHT_DECAY, seed=3, **over)

        def trainer():
            torch.manual_seed(tc.seed)
            return Trainer(tc, init_encoder(auto.build_model("distilbert", "seq-cls", cfg),
                                            seed=0, device=DEVICE))

        straight = trainer()
        losses = [float(straight.train_step(b)["loss"]) for b in batches]
        first = trainer()
        resumed = [float(first.train_step(b)["loss"]) for b in batches[:half]]
        ckpt = Checkpointer(str(work / name), async_save=False)
        ckpt.save(first.state_dict(), epoch=0, step_in_epoch=half)
        del first
        second = trainer()
        state, _, step_in_epoch = ckpt.restore()
        second.load_state_dict(state)
        ckpt.close()
        resumed += [float(second.train_step(b)["loss"]) for b in batches[half:]]
        differ = [n for (n, a), b in zip(straight.model.named_parameters(),
                                         second.model.parameters()) if not torch.equal(a, b)]
        moments = [(st_a, st_b) for st_a, st_b in zip(
            (straight.optimizer.state[p] for p in straight.params),
            (second.optimizer.state[p] for p in second.params))]
        moments_equal = all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                            for a, b in moments for k in ("exp_avg", "exp_avg_sq"))
        dtypes = sorted({str(b[k].dtype) for _, b in moments for k in ("exp_avg", "exp_avg_sq")})
        row = {"phase": "optim_resume", "optimizer": name, "steps": RESUME_STEPS,
               "resumed_at": step_in_epoch, "losses": losses,
               "losses_bitwise": losses == resumed, "params_differing": differ,
               "moments_bitwise": moments_equal, "moment_dtypes": dtypes,
               "checkpoint_step": second.step}
        emit(row)
        check(losses == resumed, f"resume ({name}): losses {losses} against {resumed}")
        check(not differ, f"resume ({name}): parameters differ: {differ[:5]}")
        check(moments_equal and dtypes == ["torch.bfloat16" if "bf16" in name
                                           else "torch.float32"],
              f"resume ({name}): moments equal {moments_equal}, dtypes {dtypes}")
        rows[name] = row
    return rows


# -- the obs phase ---------------------------------------------------------------
#
# The port's offline readers (``python -m <port>.obs``) over the telemetry
# the earlier phases wrote on the card, and the compile budget on a fresh
# process's first K1 load.

BUDGET_STEPS = 10               # the compile-budget run's train steps
BUDGET_SAMPLES = 80             # one length-sorted window: its widths climb


def _obs_cli(*argv) -> tuple[int, str]:
    """``python -m <port>.obs ARGV`` in this process: (exit code, stdout)."""
    import contextlib
    import io

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    return rc, buf.getvalue()


def compile_budget_phase(work: Path | None = None) -> dict:
    """(e) of the obs phase, in a process of its own on the card (the K1
    library then loads inside the fit, where the trainer's compile tracker
    sees it): BERT-base seq-cls at full width and depth through the
    training CLI with ``--bucket_multiple 64`` and
    ``HSTD_COMPILE_BUDGET_S=0``, ``BUDGET_STEPS`` steps over the first
    ``BUDGET_SAMPLES`` reviews. Its row: the train batcher's widths in
    order, each with whether the ladder was capped when the batch was cut,
    the K1 and K2 counts, and the run's ``compile`` and ``alert`` events."""
    import os

    from huggingface_sagemaker_tensorflow_distributed_tpu_torch import obs
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.data import pipeline

    if work is None:
        with tempfile.TemporaryDirectory() as tmp:
            return compile_budget_phase(Path(tmp))
    cfg_dir = _config_dir(work, BERT_BASE)
    tel = work / "telemetry"
    widths = []
    orig = pipeline.ShardedBatcher._trim_to_buckets

    def trim(self, batch, real_idx):
        capped = obs.compile_budget_capped(self.process_count)
        out = orig(self, batch, real_idx)
        if self.drop_remainder:      # the train batcher's batches
            widths.append([int(out["attention_mask"].shape[1]), capped])
        return out

    saved = os.environ.get("HSTD_COMPILE_BUDGET_S")
    os.environ["HSTD_COMPILE_BUDGET_S"] = "0"
    pipeline.ShardedBatcher._trim_to_buckets = trim
    obs.reset(out_dir=str(tel))
    try:
        _, trainer, launches, wall = _counted_run([
            "--model_name_or_path", str(cfg_dir), "--from_scratch", "true",
            "--dataset", "vendored_reviews", "--epochs", "1",
            "--steps_per_epoch", str(BUDGET_STEPS),
            "--max_train_samples", str(BUDGET_SAMPLES), "--do_eval", "false",
            "--bucket_multiple", str(DATA_BUCKET),
            "--output_data_dir", str(work / "out"), "--model_dir", str(work / "model"),
            "--device", DEVICE])
    finally:
        obs.reset()
        pipeline.ShardedBatcher._trim_to_buckets = orig
        if saved is None:
            os.environ.pop("HSTD_COMPILE_BUDGET_S", None)
        else:
            os.environ["HSTD_COMPILE_BUDGET_S"] = saved
    return {"budget": {"steps": trainer.step, "widths": widths, "launches": launches,
                       "events": [e for e in _events(tel) if e["type"] in ("compile", "alert")],
                       "wall_s": wall}}


def obs_phase(work: Path, card: str, job_tel, engine_tel, drain: dict,
              open_loop: dict) -> dict:
    """The telemetry the card's runs wrote, read back through ``python -m
    <port>.obs``: (a) ``validate`` and ``report`` over the launched job's
    directory ``job_tel`` (no schema error, the report valid, the child's K1
    library load among its compiles on the card, step statistics present;
    the host section printed); (b) ``goodput`` over the open-loop runs
    ``open_loop`` (rate: {``telemetry``, the ``OpenLoopDriver``'s ``slo_attainment``
    and ``slo_met``}): each run's attainment the summary's own, the JSON the same
    bytes for either order of the inputs; (c) ``slo`` and ``timeline`` over
    ``engine_tel``: one record a request, the Chrome trace parsed back with
    one span a segment; (d) ``fleet`` and ``trace`` over the drain run
    ``drain`` ({``telemetry``, ``requests``}): every trace complete, one a
    request, the most-hopped trace's narrative clean; (e) the compile
    budget (``compile_budget_phase``, a process of its own on the card):
    exactly one ``compile_budget`` alert, and no width cut under the cap
    that the batcher had not cut before but the full width."""
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.report import (
        validate_report,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.timeline import (
        collect_timelines,
        load_events,
    )
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.obs.trace import (
        collect_traces,
    )

    work.mkdir(parents=True, exist_ok=True)
    rows, seconds = {}, {}

    # (a) the launched job's report
    t0 = time.perf_counter()
    rc, out = _obs_cli("validate", job_tel)
    check(rc == 0, f"(a) validate over the launched job: rc {rc}\n{out[-2000:]}")
    rc, out = _obs_cli("report", job_tel, "-o", work / "report.json")
    check(rc == 0, f"(a) report over the launched job: rc {rc}")
    report = json.loads(out)
    check(report["errors"] == [] and validate_report(report) == []
          and json.loads((work / "report.json").read_text()) == report,
          f"(a) the report: errors {report['errors'][:3]}, {validate_report(report)}")
    host = report["hosts"]["0"]
    loads = [e["event"] for e in _events(Path(job_tel)) if e["type"] == "compile"]
    if DEVICE == "cuda":
        check("/hstd/compile/load/flash_attention" in loads and host["compile"]["count"] >= 1,
              f"(a) the child's K1 load is not among its compiles {loads}")
    check(host["step_time_s"] is not None and host["samples_per_sec"] is not None,
          "(a) the report has no step statistics")
    rows["report"] = {"phase": "obs", "run": "launch_report", "card": card, "host": host,
                      "compiles": loads, "events": report["run"]["events"]}
    seconds["a_report"] = time.perf_counter() - t0

    # (b) goodput over the wall-clock open-loop runs
    t0 = time.perf_counter()
    rates = sorted(open_loop, key=float)
    dirs = [open_loop[r]["telemetry"] for r in rates]
    rc, fwd = _obs_cli("goodput", *dirs)
    rc_rev, rev = _obs_cli("goodput", *reversed(dirs))
    check(rc == rc_rev == 0 and fwd == rev,
          f"(b) goodput: rc {rc}/{rc_rev}, the JSON differs with the order of the inputs")
    doc = json.loads(fwd)
    runs = [r for p in doc["processes"] for r in p["runs"]]
    check(len(runs) == len(rates), f"(b) goodput split {len(runs)} runs of {len(rates)}")
    for rate in rates:
        got = [r for r in runs if r.get("rate") == float(rate)]
        want = open_loop[rate]
        check(len(got) == 1 and got[0].get("slo_attainment") == want["slo_attainment"]
              and got[0].get("slo_met") == want["slo_met"],
              f"(b) rate {rate}: goodput read {got}, the run's summary {want}")
    rows["goodput"] = {"phase": "obs", "run": "goodput", "runs": len(runs),
                       "overall_attainment": doc.get("overall_attainment"),
                       "knee": doc.get("knee"),
                       "attainment_by_rate": {r: open_loop[r]["slo_attainment"] for r in rates}}
    seconds["b_goodput"] = time.perf_counter() - t0

    # (c) the engine phase's timelines
    t0 = time.perf_counter()
    events, errors = load_events([str(engine_tel)])
    check(not errors, f"(c) the engine events: {errors[:3]}")
    records = collect_timelines(events)
    rc, out = _obs_cli("slo", engine_tel)
    check(rc == 0, f"(c) slo: rc {rc}")
    slo = json.loads(out)
    rc, gantt = _obs_cli("timeline", engine_tel, "--trace", work / "engine_trace.json")
    check(rc == 0, f"(c) timeline: rc {rc}")
    chrome = json.loads((work / "engine_trace.json").read_text())
    segments = sum(len(r["segments"]) for r in records)
    check(records and slo["requests"] == len(records)
          and len(gantt.splitlines()) == 1 + len(records)
          and len(chrome["traceEvents"]) == segments
          and all(e["ph"] == "X" for e in chrome["traceEvents"]),
          f"(c) {len(records)} timelines: slo {slo['requests']}, gantt "
          f"{len(gantt.splitlines())} lines, chrome {len(chrome['traceEvents'])} of "
          f"{segments} segments")
    rows["timelines"] = {"phase": "obs", "run": "engine_timelines", "requests": len(records),
                         "segments": segments, "tail": slo["tail"]["dominant_phase_counts"],
                         "phase_time_frac": slo["phase_time_frac"]}
    seconds["c_timelines"] = time.perf_counter() - t0

    # (d) the drain run's traces
    t0 = time.perf_counter()
    rc, out = _obs_cli("fleet", drain["telemetry"], "--json", "--trace",
                       work / "fleet_trace.json")
    check(rc == 0, f"(d) fleet: rc {rc}")
    fleet = json.loads(out)
    check(fleet["traces"] == fleet["complete_traces"] == drain["requests"]
          and fleet["trace_stitch_failures"] == 0,
          f"(d) fleet: {fleet['traces']} traces, {fleet['complete_traces']} complete, "
          f"{drain['requests']} requests")
    check(json.loads((work / "fleet_trace.json").read_text())["traceEvents"],
          "(d) the fleet's Chrome trace is empty")
    traces = collect_traces(load_events([drain["telemetry"]])[0])
    hopped = max(traces, key=lambda t: (t["hops"], t["trace_id"]))
    rc, narrative = _obs_cli("trace", hopped["trace_id"], drain["telemetry"])
    check(rc == 0 and "complete" in narrative, f"(d) trace {hopped['trace_id']}: rc {rc}")
    rows["fleet"] = {"phase": "obs", "run": "drain_traces", "traces": fleet["traces"],
                     "complete_traces": fleet["complete_traces"],
                     "most_hops": hopped["hops"], "phase_frac": fleet.get("phase_frac")}
    seconds["d_fleet"] = time.perf_counter() - t0

    # (e) the compile budget
    t0 = time.perf_counter()
    budget = (_fresh_process("compile_budget_phase") if DEVICE == "cuda"
              else compile_budget_phase(work / "budget"))["budget"]
    alerts = [e for e in budget["events"]
              if e["type"] == "alert" and e["name"] == "compile_budget"]
    compiles = [e["event"] for e in budget["events"] if e["type"] == "compile"]
    check(budget["steps"] == BUDGET_STEPS and len(alerts) == 1,
          f"(e) {budget['steps']} steps, {len(alerts)} compile_budget alerts")
    full = BERT_BASE["max_position_embeddings"]
    widths = budget["widths"]
    capped = [i for i, (_, c) in enumerate(widths) if c]
    check(capped, f"(e) no batch was cut under the cap: {widths}")
    minted = [widths[i][0] for i in capped
              if widths[i][0] != full and widths[i][0] not in {w for w, _ in widths[:i]}]
    check(not minted, f"(e) widths {minted} minted under the cap: {widths}")
    if DEVICE == "cuda":
        check("/hstd/compile/load/flash_attention" in compiles
              and budget["launches"]["flash_fwd"] > 0,
              f"(e) K1: compiles {compiles}, launches {budget['launches']}")
    rows["budget"] = {"phase": "obs", "run": "compile_budget", "card": card,
                      "widths": [w for w, _ in widths], "capped_from": capped[0],
                      "alert": alerts[0]["message"], "compiles": compiles,
                      "launches": budget["launches"], "run_wall_s": budget["wall_s"]}
    seconds["e_budget"] = time.perf_counter() - t0
    rows["summary"] = {"phase": "obs", "run": "summary", "card": card, "seconds": seconds}
    for r in rows.values():
        emit(r)
    return rows


def llama_kernel_phase() -> dict:
    """The llama phase's K3 cases (``LLAMA_KERNEL_CASES`` and
    ``GEMMA_KERNEL_CASES``), held against their plain versions and timed as
    the kernel phase does (its K1 and K2 cases, ``FLASH_LLAMA``,
    ``FLASH_GEMMA``, ``VOCAB_LLAMA`` and ``VOCAB_GEMMA``, are among the
    flash and vocab-CE phases' cases)."""
    return kernel_phase([c for c in KERNEL_CASES
                         if c[0] in LLAMA_KERNEL_CASES + GEMMA_KERNEL_CASES])


# the phases that run each in a process of its own (see the module's notes)
FRESH_PROCESS_PHASES = {"flash_phase": flash_phase, "vocab_ce_phase": vocab_ce_phase,
                        "llama_kernel_phase": llama_kernel_phase,
                        "optim_memory_phase": optim_memory_phase,
                        "compile_budget_phase": compile_budget_phase}
FRESH_PROCESS_TIMEOUT_S = 600


def _fresh_process(name: str) -> dict:
    """``FRESH_PROCESS_PHASES[name]`` run by this script in a new process
    (its lines go to this process's output); its rows, keyed as the phase
    keys them. Fails if the process fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rows.json"
        sys.stdout.flush()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", name,
                               str(out)], cwd=str(ROOT), timeout=FRESH_PROCESS_TIMEOUT_S)
        check(proc.returncode == 0, f"{name} in its own process exited with {proc.returncode}")
        return _read_rows(out)


def _write_rows(rows: dict, out: Path) -> None:
    """``rows`` (keyed by a name or a tuple of them) as a JSON list of
    [key, row] pairs, a tuple key as a list."""
    out.write_text(json.dumps([[list(k) if isinstance(k, tuple) else k, row]
                               for k, row in rows.items()]))


def _read_rows(out: Path) -> dict:
    return {tuple(k) if isinstance(k, list) else k: row for k, row in json.loads(out.read_text())}


def llama_phase(work: Path, card: str) -> dict:
    """The Llama family and MoE on the card: (a) Llama-3.1-8B served on K3
    (``llama_serve_phase``), (b) Mistral's window on K3
    (``mistral_window_phase``), (c) TinyLlama trained through the CLI on K1
    and K2 (``tinyllama_train_phase``), (d) Mixtral through K1 and K2 with
    the aux loss (``mixtral_phase``), (e) Gemma-7B served on K3 at head_dim
    256 (``gemma_serve_phase``), (f) Gemma-2B trained through the CLI on
    K1 at head_dim 256 and K2 (``gemma_train_phase``). Returns every run's
    row by name."""
    import torch

    rows, seconds = {}, {}
    for name, fn, args in (("serve", llama_serve_phase, (card,)),
                           ("window", mistral_window_phase, (card,)),
                           ("train", tinyllama_train_phase, (work, card)),
                           ("moe", mixtral_phase, (card,)),
                           ("gemma_serve", gemma_serve_phase, (card,)),
                           ("gemma_train", gemma_train_phase, (work, card))):
        t0 = time.perf_counter()
        out = fn(*args)
        rows.update(out if name != "serve" else {f"llama3_8b_{k}": v for k, v in out.items()})
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "llama_summary", "card": card, "wall_seconds": seconds,
          "k3_launches": {n: r["paged_kernel_launches"] for n, r in rows.items()
                          if "paged_kernel_launches" in r},
          "k1_k2_launches": {n: r["launches"] for n, r in rows.items() if "launches" in r}})
    return rows


def main(argv: list | None = None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG} not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if argv:
        check(len(argv) == 3 and argv[0] == "--phase" and argv[1] in FRESH_PROCESS_PHASES,
              f"arguments {argv}: none, or --phase NAME OUT with NAME one of "
              f"{sorted(FRESH_PROCESS_PHASES)}")
        _no_tf32()
        _write_rows(FRESH_PROCESS_PHASES[argv[1]](), Path(argv[2]))
        return 0
    start = time.perf_counter()
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[args[0] if fn is _fresh_process else fn.__name__] = time.perf_counter() - t0
        return out

    card = timed(env_phase)
    build = timed(build_phase)
    kernels = timed(kernel_phase, [c for c in KERNEL_CASES
                                   if c[0] not in LLAMA_KERNEL_CASES + GEMMA_KERNEL_CASES])
    serve, model, trace = timed(serve_phase)
    serve_runs = timed(serve_sampling_int8_phase, model, trace, kernels)
    timed(profile_phase, model, trace, serve["wall_s"])
    with tempfile.TemporaryDirectory() as work:
        # the serve phases' telemetry stays under ``work`` for the obs phase
        engine_tel, router_tel = Path(work) / "engine_telemetry", Path(work) / "router_telemetry"
        engine_rows = timed(serve_engine_phase, model, trace, engine_tel)
        router_rows = timed(serve_router_phase, model, card, router_tel)
        del model
        torch.cuda.empty_cache()
        timed(train_parity_phase)
        train = timed(train_cli_phase, Path(work) / "train")
        timed(train_lifecycle_phase, Path(work) / "lifecycle", card,
              Path(work) / "train" / "model")
        timed(data_phase, Path(work) / "data", card)
        encoders = timed(encoder_tasks_phase, Path(work) / "encoders", card)
        mlm = timed(mlm_phase, Path(work) / "mlm", card)
        seq2seq = timed(seq2seq_phase, Path(work) / "seq2seq", card)
        packing = timed(packing_phase, Path(work) / "packing", card)
        lora = timed(lora_phase, Path(work) / "lora", card)
        deberta = timed(deberta_phase, Path(work) / "deberta", card)
        breadth = {f"{phase}/{n}": row["launches"]
                   for phase, rows_ in (("packing", packing), ("lora", lora),
                                        ("deberta", deberta))
                   for n, row in rows_.items()}
        timed(gpt2_parity_phase)
        gpt2 = timed(gpt2_cli_phase, Path(work) / "gpt2")
        timed(decode_phase, Path(work) / "gpt2" / "model", card)
        timed(seq2seq_decode_phase, Path(work) / "decode")
        timed(predict_phase, Path(work) / "predict", {
            "seq-cls": Path(work) / "train" / "model",
            "mlm": Path(work) / "mlm" / "bert_base_fused" / "model",
            "causal-lm": Path(work) / "gpt2" / "model",
            "seq2seq": Path(work) / "seq2seq" / "t5_small_fused" / "model"})
        llama = timed(llama_phase, Path(work) / "llama", card)
        launched = timed(launch_phase, Path(work) / "launch", card)
        timed(obs_phase, Path(work) / "obs", card, launched["bert_large_wwm"]["telemetry"],
              engine_tel, router_rows["drain"], router_rows["open_loop"]["wall"])
        timed(optim_parity_phase)
        timed(optim_resume_phase, Path(work) / "resume")
    flash = timed(_fresh_process, "flash_phase")
    vocab = timed(_fresh_process, "vocab_ce_phase")
    kernels.update(timed(_fresh_process, "llama_kernel_phase"))
    optim_memory = timed(_fresh_process, "optim_memory_phase")
    emit({"phase": "wall_seconds", "card": card, "by_phase": seconds,
          "total": time.perf_counter() - start})
    main_case = kernels["gpt2"]
    split_b = build[(PAGED_KERNEL_NAMES[0], 64, "float32", "float32", 1)]
    combine_b = build[(PAGED_KERNEL_NAMES[1], 64, "float32", None, None)]
    flash_rows = []
    for kname in _K1:
        r = flash[(FLASH_MAIN, kname)]
        b = build[(r["kernel_name"], r["D"], r["dtype"])]
        flash_rows.append({
            "name": kname, "route": "cuda",
            "source": FLASH_TC_SOURCE if "_tc_" in r["kernel_name"] else FLASH_SOURCE,
            "kernel": r["kernel_name"],
            "replaces": FLASH_REPLACES[kname], "launches": train["launches"][kname],
            "launches_by_path": {"bert_cli": train["launches"][kname],
                                 **{n: row["launches"][kname] for n, row in encoders.items()},
                                 **{f"mlm/{n}": row["launches"][kname]
                                    for n, row in mlm.items()},
                                 **{f"seq2seq/{n}": row["launches"][kname]
                                    for n, row in seq2seq.items()},
                                 **{n: v[kname] for n, v in breadth.items()},
                                 **{f"llama/{n}": row["launches"][kname]
                                    for n, row in llama.items() if "launches" in row},
                                 **{f"launch/{n}": row["launches"][kname]
                                    for n, row in launched.items()}},
            "launches_per_step_by_optim_run": {
                n: row["k1_launches_per_step"][kname] for n, row in optim_memory.items()},
            **{c: {k: flash[(c, kname)][k] for k in (
                "max_abs_err", "kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
               for c in (FLASH_QA, FLASH_MLM) + FLASH_LLAMA + FLASH_GEMMA},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "event_ms": r["kernel_event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "registers": b.get("registers"), "spill_store_bytes": b.get("spill_store_bytes"),
            "smem_bytes_per_block": b["smem_bytes_per_block"],
            "hmma_instructions": b["hmma_instructions"],
            "status": {c: row["status"] for (c, k), row in flash.items() if k == kname}})
    vocab_rows = []
    joint_keys = ("kernel_name", "route", "max_abs_err", "kernel_ms", "kernel_event_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms", "chunks", "dh_split_k",
                  "scratch_ms")
    case_keys = ("kernel_name", "route", "label_smoothing", "max_abs_err", "kernel_ms",
                 "kernel_event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "fwd_splits", "dh_splits", "vocab_chunk", "chunks", "scratch_ms")
    for kname in _K2:
        r = vocab[(VOCAB_MAIN, kname)]
        b = build[(r["kernel_name"], None, r["hidden_dtype"])]
        vocab_rows.append({
            "name": kname, "route": "cuda",
            "source": (VOCAB_FWD_SOURCE if r["kernel_name"] == "vocab_ce_fwd_wgmma_kernel"
                       else VOCAB_BWD_SOURCE if "_wgmma_" in r["kernel_name"]
                       else VOCAB_SOURCE),
            "kernel": r["kernel_name"], "kernels": r["kernels"],
            "replaces": VOCAB_REPLACES[kname], "launches": gpt2["launches"][kname],
            "launches_by_path": {"gpt2_cli": gpt2["launches"][kname],
                                 **{f"mlm/{n}": row["launches"][kname]
                                    for n, row in mlm.items()},
                                 **{f"seq2seq/{n}": row["launches"][kname]
                                    for n, row in seq2seq.items()},
                                 **{n: v[kname] for n, v in breadth.items()},
                                 **{f"llama/{n}": row["launches"][kname]
                                    for n, row in llama.items() if "launches" in row}},
            **{c: {k: vocab[(c, kname)].get(k) for k in case_keys}
               for c in VOCAB_MLM + VOCAB_SEQ2SEQ + VOCAB_DEBERTA + VOCAB_LLAMA
               + VOCAB_GEMMA},
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "event_ms": r["kernel_event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_fp32_ms": r["bound_fp32_ms"],
            "library_ms": r["library_ms"], "vocab_chunk": r.get("vocab_chunk"),
            "chunks": r.get("chunks"), "scratch_ms": r.get("scratch_ms"),
            "registers": b.get("registers"), "spill_store_bytes": b.get("spill_store_bytes"),
            "smem_bytes_per_block": b["smem_bytes_per_block"],
            "hmma_instructions": b["hmma_instructions"],
            "hgmma_instructions": b["hgmma_instructions"],
            # the joint backward (dH and dW from one dS) at every case
            **({"joint_backward": {c: {k: row.get(k) for k in joint_keys}
                                   for (c, k2), row in vocab.items() if k2 == "fused_ce_bwd"}}
               if kname != "fused_ce_fwd" else {}),
            "status": {c: row["status"] for (c, k), row in vocab.items() if k == kname}})
    paged_row = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "kernel": list(PAGED_KERNEL_NAMES),
        "replaces": KERNEL_REPLACES,
        "launches": serve["paged_kernel_launches"],
        "launches_by_path": {"serve": serve["paged_kernel_launches"],
                             **{f"serve_{n}": r["paged_kernel_launches"]
                                for n, r in serve_runs.items()},
                             **{f"serve_engine/{n}": r["paged_kernel_launches"]
                                for n, r in engine_rows.items()
                                if "paged_kernel_launches" in r},
                             **{f"serve_router/{n}": r["paged_kernel_launches"]
                                for n, r in router_rows.items()
                                if "paged_kernel_launches" in r},
                             **{f"llama/{n}": r["paged_kernel_launches"]
                                for n, r in llama.items() if "paged_kernel_launches" in r}},
        "llama_launches_by_width": {
            n: r["k3_launches_by_width"] for n, r in llama.items()
            if r.get("k3_launches_by_width")},
        "llama_cases": {c[0]: {k: kernels[c[0]][k] for k in (
            "max_abs_err", "kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "width", "chunk")}
            for c in KERNEL_CASES if c[0] in LLAMA_KERNEL_CASES},
        "gemma_cases": {c[0]: {k: kernels[c[0]][k] for k in (
            "max_abs_err", "kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "width", "chunk")}
            for c in KERNEL_CASES if c[0] in GEMMA_KERNEL_CASES},
        "serve_engine_launches_by_width": {
            n: r["k3_launches_by_width"] for n, r in engine_rows.items()
            if r.get("k3_launches_by_width")},
        "serve_router_launches_by_replica_width": {
            n: r["k3_launches_by_replica"] for n, r in router_rows.items()
            if r.get("k3_launches_by_replica")},
        "serve_engine_cases": {c: {k: kernels[c][k] for k in (
            "max_abs_err", "kernel_ms", "kernel_event_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "width", "chunk")}
            for c in list(LADDER_CASES.values()) + ["shared", "shared_int8"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()
                           if r["dtype"] == "float32"),
        "ms": main_case["kernel_ms"], "event_ms": main_case["kernel_event_ms"],
        "host_ms": main_case["kernel_host_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "registers": split_b["registers"], "combine_registers": combine_b["registers"],
        "spill_store_bytes": split_b["spill_store_bytes"] + combine_b["spill_store_bytes"],
        "smem_bytes_per_block": split_b["smem_bytes_per_block"],
        "status": {name: r["status"] for name, r in kernels.items()}}
    emit({"kernels": [paged_row] + flash_rows + vocab_rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
