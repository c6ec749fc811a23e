// decode_geometry.h — the split-K decode kernel's geometry: the tile, the
// ring, the shared-memory layout and the cluster-size rule.
//
// Plain C++ with no CUDA types, so that flash_attention.cu and a host
// compiler both take it: the library reports what it computes through
// flash_decode_geometry, and the CPU tests compile this header alone to
// hold the rule on shapes the card never sees.

#ifndef REPRO_TORCH_DECODE_GEOMETRY_H_
#define REPRO_TORCH_DECODE_GEOMETRY_H_

#ifdef __CUDACC__
#define DECODE_GEOMETRY_FN __host__ __device__ inline
#else
#define DECODE_GEOMETRY_FN inline
#endif

namespace decode_geometry {

constexpr int kWarps = 8;                    // consumer warps a block
constexpr int kGroups = 2;                   // warp groups, taking turns
constexpr int kGroupWarps = kWarps / kGroups;
constexpr int kThreads = 32 * (kWarps + 1);  // + one producer warp
constexpr int kTileBytes = 16384;            // per operand, the target
constexpr int kRingBytes = 196 * 1024;       // K and V slots together
constexpr int kMaxSlots = 8;
constexpr int kSmem = 216 * 1024;            // dynamic shared memory a block
constexpr int kMinSplitKeys = 64;            // no split shorter than this
constexpr int kMaxCluster = 16;              // launchable; above 8 opt-in
// The largest size the rule takes: larger clusters launch, but at
// Gemma's decode shapes they ran slower on the H100 than 8 (their fixed
// cost outgrows the SMs they add; PERF.md section 6, PR 21).
constexpr int kRuleMaxCluster = 8;

// Dimensions a lane holds of a D-long row (lanes over dimensions).
DECODE_GEOMETRY_FN constexpr int epl_for(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 8;
}

// Keys a consumer warp takes per step at GQA group (rounded up to a power
// of two) G and epl dimensions a lane: the G x keys (up to 32) scores go
// through one warp reduction, whose latency the keys share; at a group of
// 8 with 8 dimensions a lane, 2 keys leave the registers enough room.
DECODE_GEOMETRY_FN constexpr int step_keys(int G, int epl) {
  return G >= 8 ? (epl >= 8 ? 2 : 4) : G >= 4 ? 4 : 8;
}

// Whether the group's q vectors stay in shared memory rather than in
// registers (G x epl floats a lane), where they would leave too few
// registers for the accumulators and the step's scores.
DECODE_GEOMETRY_FN constexpr bool q_in_smem(int G, int epl) {
  return G * epl >= 64;
}

DECODE_GEOMETRY_FN constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// The ring of one launch at head dim D, element size esize (bytes) and
// group G.  A tile is `keys` consecutive cache rows of K and of V; each
// lands in a slot of `slot_bytes` with room for the 16-byte envelope the
// bulk copy takes around rows that do not start on a 16-byte boundary.
// The warp groups take turns at tiles (tile i goes to group i % kGroups);
// in a tile every warp of a group takes whole steps, so keys is a multiple
// of kGroupWarps x step_keys.  slots is a multiple of kGroups, so a
// slot always serves the same group: a group waits for a slot's next
// phase only after it has read the previous one, and an mbarrier parity
// wait can never pass one phase early.
struct Tile {
  int keys;
  int slots;
  int slot_bytes;
};

DECODE_GEOMETRY_FN Tile tile(int D, int esize, int G) {
  const int round = kGroupWarps * step_keys(G, epl_for(D));
  const int row = D * esize;
  int reps = kTileBytes / (round * row);
  if (reps < 1) reps = 1;
  Tile t;
  t.keys = round * reps;
  t.slot_bytes = align_up(t.keys * row + 32, 128);
  t.slots = kRingBytes / (2 * t.slot_bytes);
  if (t.slots > kMaxSlots) t.slots = kMaxSlots;
  t.slots -= t.slots % kGroups;
  return t;
}

// Byte offsets from the 128-byte aligned base of dynamic shared memory.
// The ring holds slot s's K tile at 2 s slot_bytes and its V tile one
// slot_bytes later; after the walk the consumer warps' states (m, l, acc)
// reuse it.  The block's merged state, which the cluster's rank 0 reads,
// the group's q vectors, the warps' score scratch and the mbarriers (full,
// then empty, one per slot) follow.
struct Layout {
  int states;    // kWarps x G x (2 + D) float32, over the ring
  int exchange;  // G x (2 + D) float32: m[G], l[G], acc[G][D]
  int q;         // G x D float32
  int scratch;   // kWarps x G x step_keys float32
  int barriers;  // 2 x slots x 8 bytes
  int end;
};

DECODE_GEOMETRY_FN Layout layout(const Tile& t, int D, int G) {
  Layout l;
  l.states = 0;
  const int ring = 2 * t.slots * t.slot_bytes;
  const int states = kWarps * G * (2 + D) * 4;
  l.exchange = align_up(ring > states ? ring : states, 16);
  l.q = align_up(l.exchange + G * (2 + D) * 4, 16);
  l.scratch = align_up(l.q + G * D * 4, 16);
  l.barriers =
      align_up(l.scratch + kWarps * G * step_keys(G, epl_for(D)) * 4, 8);
  l.end = l.barriers + 2 * t.slots * 8;
  return l;
}

// Whether the layout fits the dynamic shared memory a launch asks for,
// with 128 bytes to align its base, and the ring has a slot for each warp
// group.
DECODE_GEOMETRY_FN bool fits(const Tile& t, int D, int G) {
  return t.slots >= kGroups && layout(t, D, G).end + 128 <= kSmem;
}

// The cluster size C (blocks sharing one (batch row, kv head)'s live
// range) for bh = B x Hkv clusters on a card of `sms` SMs, where
// active[c - 1] clusters of c blocks fit on the card at once (0 where
// that size cannot launch), c = 1 .. kMaxCluster.  The largest C up to
// kRuleMaxCluster such that
//   * every block of the launch is resident at once, one an SM
//     (bh x C <= sms, and the card holds bh clusters of C);
//   * no split is shorter than kMinSplitKeys keys of the longest cache
//     the call could see (C x kMinSplitKeys <= s_max; the live lengths
//     stay on the device).
// C = 1 where bh already fills the card.
DECODE_GEOMETRY_FN int cluster_size(int bh, int s_max, int sms,
                                    const int* active) {
  int c = 1;
  for (int cand = 2; cand <= kRuleMaxCluster; ++cand) {
    if (active[cand - 1] >= bh && (long long)bh * cand <= sms &&
        (long long)cand * kMinSplitKeys <= s_max)
      c = cand;
  }
  return c;
}

}  // namespace decode_geometry

#endif  // REPRO_TORCH_DECODE_GEOMETRY_H_
