// Table-driven core of the env-step engine, one env per lane group.
//
// The same source is compiled twice: by nvcc into the CUDA kernels of
// engine.cu (a group of G lanes of one warp per env) and by g++ into the
// host twin of engine_host.cpp (a loop over envs, used only by the CPU
// tests). Every function here is __host__ __device__.
//
// The JAX package traces its kernel body once per model into straight-line
// code with structural zeros pruned. Here the algorithm is written once and
// loops over the tables that `ops/cuda_engine.py · pack_tables` lays out:
// bodies, dofs, contact rows, limit rows and task constants. Every sum is
// taken in the order of the JAX package's unrolled sums; a structural zero
// is a stored 0 that adds nothing, so the rounding follows the plain version
// (up to FMA contraction on the GPU and the last bits of sinf/cosf). The
// exceptions: the PGS sweep's dot products, which sum lane partials and
// then a fixed xor butterfly over the group (group_sum), the factorization
// of M and its solves, which run over the dof tree's root paths (M = L^T L,
// ltl_factor) where the plain version takes a dense Cholesky, and the
// sweep's later dots of a row: a contact row's tangent dots and a limit
// pair's second dot are formed from the row's first dots and its Gram
// entries (contact_step, limit_step), where the plain version takes a fresh
// dot after each update. The same functions, other roundings.
//
// Scope: free, hinge and slide joints (any number of free roots), point
// and disk (cylinder end-cap) contacts against planes, capsule/sphere pairs
// (self-collision), joint limits, models with no contact rows and any
// gravity; the tasks: the walker with the "cheetah", "hopper", "ant" and
// "humanoid" alive modes, Flagrun's flags and FlagrunHarder's lying reset,
// cube throw and get-up machine, Reacher, Pusher, Striker, Thrower, the
// two pendula, and the Gym-MuJoCo mirrors (the five walkers, Reacher and the
// two pendula of mujoco_family.py). pack_tables refuses anything else (other
// pre-physics hooks, other tasks, models over the caps).
//
// Lane groups. A group of G lanes (G a power of two, at most 32, a template
// parameter) steps one env. Code outside EACH_LANE is uniform: on the card
// every lane of the group runs it and computes the same values (it reads
// only what all lanes see alike); on the host it runs once. EACH_LANE(g, l)
// { ... } is lane l's share of a parallel phase: on the card lane l runs it,
// on the host a loop runs it for l = 0 .. G-1. Lanes stride over dofs, rows
// or right-hand sides (for (d = l; d < nv; d += G)); no lane reads in a
// phase what another lane writes in it, and g.sync() (__syncwarp of the
// group) separates the phases. PerLane<T, G> is lane-private state that
// lives across phases (a register on the card, an array over lanes on the
// host), and group_sum is the butterfly, emulated on the host in the card's
// order, so the host twin computes the kernels' bits up to FMA contraction.
//
// Scratch. Everything sized by the model (q, v, the FK frames, M, L, the
// forward-solved constraint rows, the PGS multipliers, obs) lives in one
// float array per env: dynamic shared memory on the card, a heap buffer on
// the host. pack_physics lays it out from the model's sizes (Tables::sc,
// the float offset of each ENG_SCRATCH array) so no array is sized by a
// cap; the constants below bound only the tables. The large, huge and sized
// classes keep the array in a device buffer on the card instead. Every class
// runs the same substep (the sweep holds a row by its window in these three).

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

// ENG_BF16_PROBE (host twin only; off by default): round to bf16 the
// operands of the products that the JAX package's XLA path takes as
// precision-less einsums, which a TPU feeds bf16 operands (dynamics.py:310,
// :327; contacts.py:596, :660-661): the bias and CRBA dots (sv_dot), the
// contact Jacobian's entries (jd) and the PGS set-up's dots (dotn).
// tools/bf16_probe.py builds the twin with it; the card's libraries never.
#if defined(ENG_BF16_PROBE) && defined(__CUDACC__)
#error "ENG_BF16_PROBE is a host-twin probe; the CUDA libraries are never built with it"
#endif

#ifdef __CUDACC__
#define ENG_HD __host__ __device__ __forceinline__
#define ENG_UNROLL _Pragma("unroll")
// unrolled by 4 so that a sum's loads issue ahead of its chain (the order of
// the sum is unchanged)
#define ENG_UNROLL4 _Pragma("unroll 4")
#else
#define ENG_HD inline
#define ENG_UNROLL
#define ENG_UNROLL4
#endif

// How the kernels of engine.cu and task_step.cu take the tables, and where
// an env's scratch lives. The default class: the tables a __grid_constant__
// parameter, passed by value from the host copy; the scratch the env's slice
// (env e of its block) of the block's dynamic shared memory `smem`. The
// large, huge and sized classes (ENG_BIG_TABLES, ENG_HUGE_TABLES,
// ENG_SIZED_TABLES, below): the tables a pointer to a copy in global memory
// (dev_tables, a leading argument of each launcher) that the wrapper uploads
// once when the env is made, which the kernel binds to the `t` that the core
// reads (in the hot PGS sweep every lane of a warp reads the same entry, a
// broadcast through L1; the launchers check the host copy); the whole
// scratch, laid out as in shared memory, in env i's slice of a device buffer
// of B x Tables::sc_stride floats (buf, an argument of their kernels and
// launchers after the tables): a block asks for no shared memory and the
// SM's memory serves as L1. ENG_ENV_SCRATCH(e, i) is the core's base
// argument of env i, the e-th of its block.
#if defined(ENG_BIG_TABLES) + defined(ENG_HUGE_TABLES) + defined(ENG_SIZED_TABLES) > 1
#error "ENG_BIG_TABLES, ENG_HUGE_TABLES and ENG_SIZED_TABLES name three size classes: build one"
#endif
#if defined(ENG_BIG_TABLES) || defined(ENG_HUGE_TABLES) || defined(ENG_SIZED_TABLES)
#define ENG_GLOBAL_TABLES
#endif
#ifdef ENG_GLOBAL_TABLES
#define ENG_TABLES_PARAM const eng::Tables* __restrict__ tp
#define ENG_TABLES_BIND const eng::Tables& t = *tp;
#define ENG_DEV_TABLES const void* dev_tables,
#define ENG_KERNEL_TABLES(host) ((const eng::Tables*)dev_tables)
#define ENG_BUF_PARAM float* __restrict__ buf,
#define ENG_KERNEL_BUF buf,
#define ENG_ENV_SCRATCH(e, i) buf + (size_t)(i) * t.sc_stride
#else
#define ENG_TABLES_PARAM const __grid_constant__ eng::Tables t
#define ENG_TABLES_BIND
#define ENG_DEV_TABLES
#define ENG_KERNEL_TABLES(host) (host)
#define ENG_BUF_PARAM
#define ENG_KERNEL_BUF
#define ENG_ENV_SCRATCH(e, i) smem + (e) * t.sc_stride
#endif

namespace eng {

// ---- caps; pack_tables raises above them -----------------------------------
// The Tables struct, in one of four size classes chosen at compile time. A
// root-path mask is MASK_WORDS uint32 words (anc_mask, anc_mask_hi): two,
// up to 64 dofs, in the default and large classes; four in the huge one;
// ceil(MAX_NV / 32) in the sized one.
// The default class keeps the tables a __grid_constant__ kernel parameter
// (at most 32,764 bytes); Atlas (31 bodies, nq 37, nv 36, 60 limit rows, 30
// actuators, 31 part frames) is its largest shipped model.
#if !defined(ENG_BIG_TABLES) && !defined(ENG_HUGE_TABLES) && !defined(ENG_SIZED_TABLES)
constexpr int MAX_BODIES = 32;
constexpr int MAX_NV = 40;
constexpr int MAX_NQ = 41;        // a free joint has 7 q entries and 6 dofs
constexpr int MAX_ROWS = 108;     // contact rows, point rows first
constexpr int MAX_PAIRS = 80;     // of which capsule/sphere pair rows
constexpr int MAX_LIMITS = 64;    // joint-limit rows (two a limited joint)
constexpr int MAX_ACT = 32;
constexpr int MAX_PARTS = 32;
constexpr int MAX_DRAWS = 41;     // reset draws into q (up to MAX_NQ), and into v
#elif defined(ENG_BIG_TABLES)
// The large class (-DENG_BIG_TABLES): models over the default caps, such as
// two humanoids in one scene (36 bodies, nq 48, nv 46, 68 limit rows, 34
// actuators). Its tables (~70 KB) outgrow the kernel parameters, so the
// kernels read a copy in global memory (engine.cu); its scratch lives in a
// device buffer, as the huge class's.
// ops/cuda_engine.py reads these caps by their BIG_ names.
constexpr int BIG_MAX_BODIES = 64;   // one body a dof at nv 64
constexpr int BIG_MAX_NV = 64;       // the two-word root-path mask's limit
constexpr int BIG_MAX_NQ = 80;       // nq <= 7/6 nv: 74 at nv 64 (ten free joints)
constexpr int BIG_MAX_ROWS = 256;    // about where one env's scratch outgrows shared memory at nv 64
constexpr int BIG_MAX_PAIRS = 128;   // half of them
constexpr int BIG_MAX_LIMITS = 128;  // two a limited dof at nv 64
constexpr int BIG_MAX_ACT = 64;      // one a dof
constexpr int BIG_MAX_PARTS = 64;    // one a body
constexpr int BIG_MAX_DRAWS = 80;    // a draw for every q (BIG_MAX_NQ) and every dof
constexpr int MAX_BODIES = BIG_MAX_BODIES;
constexpr int MAX_NV = BIG_MAX_NV;
constexpr int MAX_NQ = BIG_MAX_NQ;
constexpr int MAX_ROWS = BIG_MAX_ROWS;
constexpr int MAX_PAIRS = BIG_MAX_PAIRS;
constexpr int MAX_LIMITS = BIG_MAX_LIMITS;
constexpr int MAX_ACT = BIG_MAX_ACT;
constexpr int MAX_PARTS = BIG_MAX_PARTS;
constexpr int MAX_DRAWS = BIG_MAX_DRAWS;
#elif defined(ENG_HUGE_TABLES)
// The huge class (-DENG_HUGE_TABLES): models over the large class's caps,
// or whose one-env scratch outgrows a block's shared memory, such as four
// humanoids in one scene (72 bodies, nq 96, nv 92, 116 floor rows, 136
// limit rows, 68 actuators). Its tables (~105 KB) live in global memory as
// the large class's do; its scratch lives in a device buffer
// (ENG_ENV_SCRATCH above).
// ops/cuda_engine.py reads these caps by their HUGE_ names.
constexpr int HUGE_MAX_BODIES = 128;  // one body a dof at nv 128
constexpr int HUGE_MAX_NV = 128;      // the four-word root-path mask's limit
constexpr int HUGE_MAX_NQ = 160;      // nq <= 7/6 nv: 149 at nv 128
constexpr int HUGE_MAX_ROWS = 512;    // twice the large class's
constexpr int HUGE_MAX_PAIRS = 256;   // half of them
constexpr int HUGE_MAX_LIMITS = 256;  // two a limited dof at nv 128
constexpr int HUGE_MAX_ACT = 128;     // one a dof
constexpr int HUGE_MAX_PARTS = 128;   // one a body
constexpr int HUGE_MAX_DRAWS = 160;   // a draw for every q (HUGE_MAX_NQ) and every dof
constexpr int HUGE_MASK_WORDS = 4;
constexpr int MAX_BODIES = HUGE_MAX_BODIES;
constexpr int MAX_NV = HUGE_MAX_NV;
constexpr int MAX_NQ = HUGE_MAX_NQ;
constexpr int MAX_ROWS = HUGE_MAX_ROWS;
constexpr int MAX_PAIRS = HUGE_MAX_PAIRS;
constexpr int MAX_LIMITS = HUGE_MAX_LIMITS;
constexpr int MAX_ACT = HUGE_MAX_ACT;
constexpr int MAX_PARTS = HUGE_MAX_PARTS;
constexpr int MAX_DRAWS = HUGE_MAX_DRAWS;
#else
// The sized class (-DENG_SIZED_TABLES): models over the huge class's caps,
// or whose scratch outside Y outgrows a block's shared memory, such as ten
// humanoids in one scene (180 bodies, nq 240, nv 230, 290 floor rows, 340
// limit rows, 170 actuators). Its caps are the model's own sizes, rounded up
// by ops/cuda_engine.py · sized_caps and given as -DSIZED_MAX_*=n (and
// -DSIZED_MASK_WORDS=ceil(MAX_NV / 32), at least 2), so no model size is
// refused; one library serves every model that rounds to the same caps. The
// tables live in global memory; the scratch is stored and placed as the
// huge class's.
#if !defined(SIZED_MAX_BODIES) || !defined(SIZED_MAX_NV) || !defined(SIZED_MAX_NQ) ||    \
    !defined(SIZED_MAX_ROWS) || !defined(SIZED_MAX_PAIRS) || !defined(SIZED_MAX_LIMITS) || \
    !defined(SIZED_MAX_ACT) || !defined(SIZED_MAX_PARTS) || !defined(SIZED_MAX_DRAWS) ||   \
    !defined(SIZED_MASK_WORDS)
#error "the sized class takes its caps as -DSIZED_MAX_{BODIES,NV,NQ,ROWS,PAIRS,LIMITS,ACT,PARTS,DRAWS}=n and -DSIZED_MASK_WORDS=n"
#endif
constexpr int MAX_BODIES = SIZED_MAX_BODIES;
constexpr int MAX_NV = SIZED_MAX_NV;
constexpr int MAX_NQ = SIZED_MAX_NQ;
constexpr int MAX_ROWS = SIZED_MAX_ROWS;
constexpr int MAX_PAIRS = SIZED_MAX_PAIRS;
constexpr int MAX_LIMITS = SIZED_MAX_LIMITS;
constexpr int MAX_ACT = SIZED_MAX_ACT;
constexpr int MAX_PARTS = SIZED_MAX_PARTS;
constexpr int MAX_DRAWS = SIZED_MAX_DRAWS;
#endif
#if defined(ENG_HUGE_TABLES)
constexpr int MASK_WORDS = HUGE_MASK_WORDS;
#elif defined(ENG_SIZED_TABLES)
constexpr int MASK_WORDS = SIZED_MASK_WORDS;
#else
constexpr int MASK_WORDS = 2;
#endif
// The size class of a model without pair rows within these (Hopper ... Ant,
// Reacher, the pendula: caps_id 0; the others 1; a model of the large
// class's tables 2, of the huge class's 3, of the sized class's 4), kept as
// a model property
constexpr int WALKER_BODIES = 16;
constexpr int WALKER_NV = 16;
constexpr int WALKER_NQ = 17;
constexpr int WALKER_ROWS = 32;
constexpr int WALKER_LIMITS = 32;
constexpr int WALKER_ACT = 16;
constexpr int MAX_FEET = 8;
constexpr int MAX_AUX = 8;        // per-env task state, in sorted key order
constexpr int MAX_COMP = 5;       // reward components, in sorted key order
constexpr int MAX_SLOTS = 40;     // entries of Tables::sc
constexpr int JT_FREE = 0;        // q: position, then quaternion (w, x, y, z);
                                  // v: body-frame angular, then linear
constexpr int JT_HINGE = 1;
constexpr int JT_SLIDE = 2;
constexpr int ALIVE_CHEETAH = 0;  // WalkerSpec.alive_mode, as pack_tables codes it
constexpr int ALIVE_HOPPER = 1;
constexpr int ALIVE_ANT = 2;
constexpr int ALIVE_HUMANOID = 3;
constexpr int TASK_WALKER = 0;    // the task class, as pack_tables codes it
constexpr int TASK_FLAGRUN = 1;
constexpr int TASK_FLAGRUN_HARDER = 2;
constexpr int TASK_REACHER = 3;
constexpr int TASK_PUSHER = 4;
constexpr int TASK_STRIKER = 5;
constexpr int TASK_THROWER = 6;
constexpr int TASK_PENDULUM = 7;  // with or without the swing-up
constexpr int TASK_DOUBLE_PENDULUM = 8;
constexpr int TASK_MJ_WALKER = 9;  // mujoco_family.py: Hopper ... Humanoid
constexpr int TASK_MJ_REACHER = 10;
constexpr int TASK_MJ_PENDULUM = 11;
constexpr int TASK_MJ_DOUBLE_PENDULUM = 12;
constexpr int MJ_DONE_NEVER = 0;  // the MuJoCo walkers' done rule (mj_done)
constexpr int MJ_DONE_HOPPER = 1;
constexpr int MJ_DONE_WALKER = 2;
constexpr int MJ_DONE_ANT = 3;
constexpr int MJ_DONE_HUMANOID = 4;

// The per-env scratch arrays, in layout order; ops/cuda_engine.py ·
// scratch_layout sizes each from the model and parses this list.
#define ENG_SCRATCH(X)                                                         \
  X(q) X(v) X(tau) X(act) X(aux) X(obs)                                       \
  X(R) X(p) X(vel) X(com) X(S) X(inert) X(avp) X(f)                           \
  X(L) X(inv_diag) X(depth) X(P) X(dirs) X(z) X(zp) X(v3o) X(vp)        \
  X(Y) X(dinv) X(b_vel) X(b_pos) X(dinv_l) X(b_l)                             \
  X(lam_n) X(lam_t1) X(lam_t2) X(lam_p) X(lam_l) X(dofs) X(crow) X(lrow)
#define ENG_SLOT(name) SC_##name,
enum Slot { ENG_SCRATCH(ENG_SLOT) SC_COUNT };
#undef ENG_SLOT
// Every class keeps its PGS scalars by row, so that one address reaches a
// row's scalars in the sweep: a contact row's CROW floats in crow (its
// multipliers, right-hand sides, inverse diagonals, Gram entries y_n.y_t1,
// y_n.y_t2, y_t1.y_t2) and a limit row's LROW in lrow (multiplier, right-hand
// side, inverse diagonal; a limit pair's second row the pair's |w|^2, its
// inverse diagonal the first's); ops/cuda_engine.py sizes both. dinv ...
// lam_l are empty and unread: removing them moved Tables::sc's indices and
// took the G=8 env kernels 2.0-2.3% slower on an H100 (PERF.md §6).
enum CRow {
  CR_LAM_N, CR_LAM_T1, CR_LAM_T2, CR_LAM_P, CR_B_VEL, CR_B_POS,
  CR_DINV, CR_GRAM = CR_DINV + 3, CROW = CR_GRAM + 3
};
enum LRow { LR_LAM, LR_B, LR_D, LROW };
static_assert(SC_COUNT <= MAX_SLOTS, "Tables::sc is too short");
static_assert(MAX_NV <= 32 * MASK_WORDS, "a root-path mask is MASK_WORDS 32-bit words");
static_assert(MASK_WORDS >= 2, "anc_mask_hi holds at least one word a body");
static_assert(MAX_DRAWS >= MAX_NQ && MAX_DRAWS >= MAX_NV, "a draw for every q and every dof");

// The most dofs a library of G lanes steps: pick_lanes (ops/cuda_engine.py)
// gives a model the narrowest G whose bound holds it, and the lanes' dof
// vectors (LaneVec) are sized by it, so the narrow libraries keep one or
// two registers a vector; at G = 32 a model over 32 dofs (Atlas) takes two.
constexpr int LANE_NV_4 = 4;
constexpr int LANE_NV_8 = 12;
constexpr int LANE_NV_16 = 16;
template <int G>
constexpr int lane_nv() {
  return G == 4 ? LANE_NV_4 : G == 8 ? LANE_NV_8 : G == 16 ? LANE_NV_16 : MAX_NV;
}

// The table layout, as one list. S(type, name) is a scalar, A(type, name,
// count) a flat array. ops/cuda_engine.py parses this list to build the
// matching ctypes structure, and checks it against eng_tables_layout().
// Every field is 4 bytes wide, so the struct has no padding.
#define ENG_TABLE_FIELDS(S, A)                                                \
  S(int32_t, nb)                                                              \
  S(int32_t, nq)                                                              \
  S(int32_t, nv)                                                              \
  S(int32_t, nr)                                                              \
  S(int32_t, nl)                                                              \
  S(int32_t, npair) /* the last npair contact rows are pair rows */          \
  S(int32_t, caps_id) /* 0 walker-sized, 1 large, 2 large class, 3 huge, 4 sized */ \
  S(int32_t, lanes) /* G, the lanes of an env's group (a power of two) */     \
  S(int32_t, sc_stride) /* floats of one env's scratch (odd; huge, sized: Y_ALIGN) */ \
  S(int32_t, sc_ld) /* Y's dynamics row: nv, made odd */                      \
  S(int32_t, sc_ldm) /* nv, made odd; no kernel reads it */                   \
  A(int32_t, sc, MAX_SLOTS) /* float offset of each ENG_SCRATCH array */     \
  S(int32_t, frame_skip)                                                      \
  S(int32_t, iterations)                                                      \
  S(int32_t, e_comb_zero)                                                     \
  S(int32_t, act)                                                             \
  S(int32_t, nfeet)                                                           \
  S(int32_t, nparts)                                                          \
  S(int32_t, obs_dim)                                                         \
  S(int32_t, obs_live) /* obs entries the task writes; the rest repeat the  \
                          value it leaves in obs[obs_live] (zero blocks) */ \
  S(int32_t, max_steps)                                                       \
  S(int32_t, base_body)                                                       \
  S(int32_t, alive_mode)                                                      \
  S(int32_t, task_kind)                                                       \
  /* physics constants, each the float32 of the JAX package's constant */     \
  S(float, dt)                                                                \
  A(float, gravity_neg, 3)                                                    \
  S(float, max_velocity)                                                      \
  S(float, erp_over_dt)                                                       \
  S(float, slop)                                                              \
  S(float, limit_erp_over_dt)                                                 \
  S(float, reg)                                                               \
  S(float, neg_e_comb)                                                        \
  S(float, neg_rest_threshold)                                                \
  /* bodies, parents before children */                                      \
  A(int32_t, parent, MAX_BODIES)                                              \
  A(int32_t, jtype, MAX_BODIES)                                               \
  A(int32_t, q_adr, MAX_BODIES)                                               \
  A(int32_t, v_adr, MAX_BODIES)                                               \
  A(int32_t, has_mass, MAX_BODIES)                                            \
  A(uint32_t, anc_mask, MAX_BODIES) /* bit d: dof d on the root path */       \
  /* word w >= 1 of body i's mask at (w - 1) MAX_BODIES + i: bit d is dof   \
     32 w + d */                                                              \
  A(uint32_t, anc_mask_hi, MAX_BODIES * MASK_WORDS - MAX_BODIES)              \
  A(float, off_r, MAX_BODIES * 9)                                             \
  A(float, off_p, MAX_BODIES * 3)                                             \
  A(float, jpos, MAX_BODIES * 3)                                              \
  A(float, jaxis, MAX_BODIES * 3)                                             \
  A(float, jref, MAX_BODIES)                                                  \
  A(float, mass, MAX_BODIES)                                                  \
  A(float, cmass, MAX_BODIES) /* composite (subtree) mass, CRBA */            \
  A(float, com, MAX_BODIES * 3)                                               \
  A(float, inertia, MAX_BODIES * 9)                                           \
  /* dofs */                                                                  \
  A(float, neg_damping, MAX_NV)                                               \
  A(float, neg_stiffness, MAX_NV)                                             \
  A(float, springref, MAX_NV)                                                 \
  A(float, armature, MAX_NV)                                                  \
  A(int32_t, dof_body, MAX_NV)                                                \
  A(int32_t, dof_qadr, MAX_NV) /* q entry of a hinge/slide dof */             \
  A(float, qpos0, MAX_NQ)                                                     \
  /* contact rows: point and disk candidates against planes (r < nr -      \
     npair); a disk row is a rim point of a cylinder's end cap */            \
  A(int32_t, row_body, MAX_ROWS)                                              \
  A(float, row_local, MAX_ROWS * 3) /* point, or the end cap's centre */      \
  A(int32_t, row_disk, MAX_ROWS) /* 0 point; 1 or 2: the rim along e1, e2 */  \
  A(float, row_axis, MAX_ROWS * 3) /* a disk row's cylinder axis */           \
  A(float, row_rim, MAX_ROWS) /* a disk row's signed radius along e */        \
  A(float, row_n, MAX_ROWS * 3)                                               \
  A(float, row_t1, MAX_ROWS * 3)                                              \
  A(float, row_t2, MAX_ROWS * 3)                                              \
  A(float, row_depth0, MAX_ROWS) /* plane_d + radius (0 for a disk) */       \
  A(float, row_nrad, MAX_ROWS * 3) /* n * radius */                           \
  A(float, row_mu, MAX_ROWS) /* every row; a pair's is the product */       \
  /* pair rows (row nr - npair + k): segment ends in the bodies' frames */    \
  A(int32_t, pair_a, MAX_PAIRS)                                               \
  A(int32_t, pair_b, MAX_PAIRS)                                               \
  A(float, pair_a0, MAX_PAIRS * 3)                                            \
  A(float, pair_a1, MAX_PAIRS * 3)                                            \
  A(float, pair_b0, MAX_PAIRS * 3)                                            \
  A(float, pair_b1, MAX_PAIRS * 3)                                            \
  A(float, pair_rsum, MAX_PAIRS) /* ra + rb */                                \
  A(float, pair_ra, MAX_PAIRS)                                                \
  A(float, pair_rb, MAX_PAIRS)                                                \
  /* joint-limit rows */                                                      \
  A(int32_t, lim_dof, MAX_LIMITS)                                             \
  A(int32_t, lim_qadr, MAX_LIMITS)                                            \
  A(float, lim_sign, MAX_LIMITS)                                              \
  A(float, lim_bound, MAX_LIMITS)                                             \
  /* task: actuated joints (torque = gain * clip(a)) */                      \
  A(int32_t, act_dof, MAX_ACT)                                                \
  A(int32_t, act_qadr, MAX_ACT)                                               \
  A(float, gain, MAX_ACT)                                                     \
  A(float, j_mid, MAX_ACT)                                                    \
  A(float, j_half, MAX_ACT)                                                   \
  /* frames the outputs read: the walkers' parts; Reacher's fingertip and    \
     target; the arms' tips, object and goal */                              \
  A(int32_t, part_host, MAX_PARTS)                                            \
  A(float, part_pos, MAX_PARTS * 3)                                           \
  A(int32_t, row_foot, MAX_ROWS) /* the foot whose geom row r is, or -1 */    \
  /* other joints a task reads (q address, dof): Reacher's target x, y;     \
     a pendulum's hinges; the MuJoCo Reacher's joints, then target x, y */   \
  A(int32_t, jq, 4)                                                           \
  A(int32_t, jv, 4)                                                           \
  S(int32_t, swingup)                                                         \
  /* reset: q = qpos0 (the task's fixed entries included), then draws      \
     q[adr] = base + U[lo, lo + span) and v[dof] = U[vlo, vlo + vspan) */    \
  S(int32_t, nqdraw)                                                          \
  A(int32_t, qdraw_adr, MAX_DRAWS)                                            \
  A(int32_t, qdraw_stream, MAX_DRAWS)                                         \
  A(float, qdraw_base, MAX_DRAWS)                                             \
  A(float, qdraw_lo, MAX_DRAWS)                                               \
  A(float, qdraw_span, MAX_DRAWS)                                             \
  S(int32_t, nvdraw)                                                          \
  A(int32_t, vdraw_dof, MAX_DRAWS)                                            \
  A(int32_t, vdraw_stream, MAX_DRAWS)                                         \
  S(float, vdraw_lo)                                                          \
  S(float, vdraw_span)                                                        \
  /* Pusher's object, Striker's goal: a point drawn on two streams, pushed   \
     out to >= 0.18 from a centre, less a base, into two q entries (x, y) */ \
  A(int32_t, push_qadr, 2)                                                    \
  A(int32_t, push_stream, 2)                                                  \
  A(float, push_lo, 2)                                                        \
  A(float, push_span, 2)                                                      \
  A(float, push_centre, 2)                                                    \
  A(float, push_base, 2)                                                      \
  /* the MuJoCo Reacher's target: r = disk_r sqrt(U[0, 1)) on stream        \
     disk_streams[0], angle U[lo, lo + span) on disk_streams[1], into jq[2], \
     jq[3] as r cos, r sin */                                                \
  A(int32_t, disk_streams, 2)                                                 \
  S(float, disk_r)                                                            \
  S(float, disk_ang_lo)                                                       \
  S(float, disk_ang_span)                                                     \
  /* aux: the slot of each key in sorted key order, -1 where absent */        \
  S(int32_t, naux)                                                            \
  S(int32_t, ax_flag_count)                                                   \
  S(int32_t, ax_flag_timeout)                                                 \
  S(int32_t, ax_frame)                                                        \
  S(int32_t, ax_ground_counter)                                               \
  S(int32_t, ax_hit)                                                          \
  S(int32_t, ax_hit_x)                                                        \
  S(int32_t, ax_hit_y)                                                        \
  S(int32_t, ax_initial_z)                                                    \
  S(int32_t, ax_min_dist)                                                     \
  S(int32_t, ax_potential)                                                    \
  S(int32_t, ax_strike_x)                                                     \
  S(int32_t, ax_strike_y)                                                     \
  S(int32_t, ax_strike_z)                                                     \
  S(int32_t, ax_striked)                                                      \
  S(int32_t, ax_target_x)                                                     \
  S(int32_t, ax_target_y)                                                     \
  S(int32_t, ax_x)                                                            \
  /* reward components: likewise */                                           \
  S(int32_t, ncomp)                                                           \
  S(int32_t, cp_alive)                                                        \
  S(int32_t, cp_ctrl)                                                         \
  S(int32_t, cp_ctrl_cost)                                                    \
  S(int32_t, cp_dist)                                                         \
  S(int32_t, cp_dist_penalty)                                                 \
  S(int32_t, cp_electricity)                                                  \
  S(int32_t, cp_feet_collision)                                               \
  S(int32_t, cp_forward)                                                      \
  S(int32_t, cp_joints_at_limit)                                              \
  S(int32_t, cp_near)                                                         \
  S(int32_t, cp_progress)                                                     \
  S(int32_t, cp_reward)                                                       \
  S(int32_t, cp_stuck_joint)                                                  \
  S(int32_t, cp_vel_penalty)                                                  \
  /* walkers */                                                               \
  S(float, initial_z)                                                         \
  S(float, target_x)                                                          \
  S(float, target_y)                                                          \
  S(float, control_dt)                                                        \
  S(float, elec_coef)                                                         \
  S(float, stall_coef)                                                        \
  S(float, limit_coef)                                                        \
  S(float, n_act)                                                             \
  /* Flagrun: flag draws U[lo, lo + span) on streams (x, y) */               \
  A(int32_t, flag_streams, 2)                                                 \
  S(float, flag_lo_x)                                                         \
  S(float, flag_span_x)                                                       \
  S(float, flag_lo_y)                                                         \
  S(float, flag_span_y)                                                       \
  S(float, flag_timeout)                                                      \
  /* FlagrunHarder: lying reset on streams (lying?, side) */                 \
  A(int32_t, lie_streams, 2)                                                  \
  S(int32_t, root_qadr)                                                       \
  S(float, lie_z)                                                             \
  S(float, lie_c)                                                             \
  /* the cube: streams (angle, speed, jitter x, y, z) */                     \
  A(int32_t, cube_streams, 5)                                                 \
  S(int32_t, cube_qadr)                                                       \
  S(int32_t, cube_vadr)                                                       \
  S(float, cube_period)                                                       \
  S(float, cube_min_frame)                                                    \
  S(float, cube_from_dist)                                                    \
  S(float, angle_lo)                                                          \
  S(float, angle_span)                                                        \
  S(float, speed_lo)                                                          \
  S(float, speed_span)                                                        \
  S(float, jitter_lo)                                                         \
  S(float, jitter_span)                                                       \
  S(float, ground_limit)                                                      \
  /* the MuJoCo walkers: reward = (alive + fwd vx) - ctrl sum(a^2); obs    \
     [q[2:], MuJoCo's qvel] (mj_free) or [q[1:], clip(v, +-10) if          \
     mj_clip_qvel]; done by mj_done */                                        \
  S(int32_t, mj_free)                                                         \
  S(int32_t, mj_clip_qvel)                                                    \
  S(int32_t, mj_done)                                                         \
  S(float, mj_alive)                                                          \
  S(float, mj_fwd)                                                            \
  S(float, mj_ctrl)

// The root paths, in every class. Dofs are numbered parents first and a
// body's dofs after its parent body's, so dof d's ancestors in the dof tree
// (Featherstone's lambda chain) are the dofs of its body's root path below
// d, lowest first; their count is d's depth. M = L^T L factors over that
// tree without fill (L(d, e) != 0 only for e an ancestor of d or d), so L
// is stored by ancestor rows: row d holds dof_depth[d] + 1 floats, L(d, e)
// at L[anc_row[d] + dof_depth[e]], root first. A constraint row's support
// is the union of its bodies' root paths (closed under ancestors), and
// L^-T of a vector on it stays on it, so Y stores each row over its support
// by position: a dof d of body a's root path at dof_depth[d], a dof of body
// b's path only (a pair row) after those, at dof_depth[d] + na, na the dofs
// of a's path that are not on b's (`PathRow`). Row j is contact row j (j <
// nr), then limit row j - nr (its support its dof's chain).
// These dofs are the model's in the order of dof_perm: a free joint's
// linear dofs before its angular ones, so that the leaf-first elimination
// takes the angular ones first, their pivots the body's inertia about the
// origin, and the linear ones last, as the plain version's root-first
// Cholesky does. The other way round the angular pivots are the Schur
// complement that is the body's inertia about its COM, which float32 loses
// to the parallel-axis term of a body far from the origin: it can turn
// negative. dof_perm is its own inverse and keeps each body's dofs in their
// index range (so its root-path mask). A set of dofs is MASK_WORDS words.
// ops/cuda_engine.py · _path_storage sets these from the model's root paths
// and lays out L and Y. The kernels read them at uniform indices in the
// PGS sweep (one row ahead) and at lane-divergent ones once a substep.
#define ENG_PATH_FIELDS(S, A)                                                 \
  A(int32_t, dof_perm, MAX_NV) /* the model's dof of dof d (above) */         \
  A(int32_t, dof_depth, MAX_NV) /* the ancestors of dof d */                  \
  A(int32_t, anc_row, MAX_NV) /* the float offset of d's row of L */          \
  A(uint32_t, dof_anc, MASK_WORDS * MAX_NV) /* d's ancestors: words from    \
                                               MASK_WORDS d */              \
  A(int32_t, path_y, MAX_ROWS + MAX_LIMITS) /* Y offset of row j (a contact \
                                               row's normal; its tangents   \
                                               follow, its support's size   \
                                               apart; a limit pair's rows   \
                                               one offset) */               \
  A(uint32_t, path_u, MASK_WORDS * MAX_ROWS + MASK_WORDS * MAX_LIMITS) /*   \
                                                 row j's support */         \
  A(uint32_t, pair_pa, MASK_WORDS * MAX_PAIRS) /* pair row k's body a's path */ \
  A(int32_t, pair_na, MAX_PAIRS) /* its dofs that are not on body b's */     \
  /* the sweep's limit steps: a limit row, or a pair (rows m, m + 1 of one   \
     dof, one Y row), each solved, set up and swept as one (limit_step) */   \
  S(int32_t, lim_steps)                                                       \
  A(int32_t, lim_first, MAX_LIMITS) /* step k's first limit row */            \
  /* timing only (tools/kernel_phases.py): 0 runs the whole substep; 1       \
     returns after FK, RNE and the composite inertias, 2 after the CRBA rows \
     and the narrowphase, 3 after the factorization */                       \
  S(int32_t, stop_after)
// The longest support whose forward solve keeps the row in registers
// (path_solve_t). pack_physics gives a model with a longer one a global
// class, which solves such a row in the scratch (path_solve_mem).
constexpr int PATH_CAP = 24;

// The global classes' sweep windows (pgs_sweeps_win) and the factorization's
// lower bound: their models have many trees, a dof's ancestors and most
// rows' supports within one.
#ifdef ENG_GLOBAL_TABLES
#define ENG_WIN_FIELDS(S, A)                                                  \
  A(int32_t, dof_lo, MAX_NV) /* the lowest of dof d's ancestors, or d */      \
  A(int32_t, path_n, MAX_ROWS + MAX_LIMITS) /* row j's support's size */      \
  A(int32_t, path_w0, MAX_ROWS + MAX_LIMITS) /* its window's first word   \
                                                (<= MASK_WORDS - 2) */       \
  A(int32_t, path_w1, MAX_ROWS + MAX_LIMITS) /* its support's last word */   \
  A(uint32_t, path_win, 2 * MAX_ROWS + 2 * MAX_LIMITS) /* its support's     \
                                                         words w0, w0 + 1 */ \
  A(uint32_t, pair_win, 2 * MAX_PAIRS) /* pair row k's body a's, likewise */ \
  A(int32_t, pair_nab, MAX_PAIRS) /* the dofs of body a's path */
#else
#define ENG_WIN_FIELDS(S, A)
#endif

#define ENG_DECL_S(T, name) T name;
#define ENG_DECL_A(T, name, n) T name[n];
struct Tables {
  ENG_TABLE_FIELDS(ENG_DECL_S, ENG_DECL_A)
  ENG_WIN_FIELDS(ENG_DECL_S, ENG_DECL_A)
  ENG_PATH_FIELDS(ENG_DECL_S, ENG_DECL_A)
};
#undef ENG_DECL_S
#undef ENG_DECL_A
#ifndef ENG_GLOBAL_TABLES
// a __grid_constant__ kernel parameter: at most 32,764 bytes of parameters
static_assert(sizeof(Tables) + 256 <= 32764, "the tables outgrow the kernel parameters");
#endif

// A set of dofs in MASK_WORDS words. Every "is dof d on body i's root path"
// test goes through on_path, which reads the word that holds d.
ENG_HD int popc32(uint32_t w) {
#ifdef __CUDA_ARCH__
  return __popc(w);
#else
  return __builtin_popcount(w);
#endif
}
ENG_HD int low_bit(uint32_t w) {  // w != 0
#ifdef __CUDA_ARCH__
  return __ffs(w) - 1;
#else
  return __builtin_ctz(w);
#endif
}
ENG_HD int high_bit(uint32_t w) {  // w != 0
#ifdef __CUDA_ARCH__
  return 31 - __clz(w);
#else
  return 31 - __builtin_clz(w);
#endif
}
#if !defined(ENG_HUGE_TABLES) && !defined(ENG_SIZED_TABLES)
// two words: bit d of lo is dof d (0-31), bit d - 32 of hi is dof d (32-63)
struct DofSet {
  uint32_t lo, hi;
};
ENG_HD DofSet anc_path(const Tables& t, int i) {
  DofSet p = {t.anc_mask[i], t.anc_mask_hi[i]};
  return p;
}
// the set in words MASK_WORDS j, MASK_WORDS j + 1 of a table array
ENG_HD DofSet dofs_at(const uint32_t* a, int j) {
  DofSet p = {a[MASK_WORDS * j], a[MASK_WORDS * j + 1]};
  return p;
}
ENG_HD DofSet dofs_none() {
  DofSet p = {0u, 0u};
  return p;
}
ENG_HD bool on_path(DofSet p, int d) { return (((d < 32 ? p.lo : p.hi) >> (d & 31)) & 1u) != 0; }
ENG_HD bool dofs_any(DofSet p) { return (p.lo | p.hi) != 0u; }
ENG_HD int dofs_count(DofSet p) { return popc32(p.lo) + popc32(p.hi); }
ENG_HD DofSet dofs_and_not(DofSet a, DofSet b) {
  DofSet r = {a.lo & ~b.lo, a.hi & ~b.hi};
  return r;
}
// Removes and returns p's highest dof (p not empty)
ENG_HD int dofs_pop_high(DofSet& p) {
  if (p.hi) {
    const int b = high_bit(p.hi);
    p.hi &= ~(1u << b);
    return 32 + b;
  }
  const int b = high_bit(p.lo);
  p.lo &= ~(1u << b);
  return b;
}
// Removes and returns p's lowest dof (p not empty)
ENG_HD int dofs_pop_low(DofSet& p) {
  if (p.lo) {
    const int b = low_bit(p.lo);
    p.lo &= p.lo - 1u;
    return b;
  }
  const int b = low_bit(p.hi);
  p.hi &= p.hi - 1u;
  return 32 + b;
}
#else
// MASK_WORDS words (four in the huge class): bit d - 32 k of w[k] is dof d.
// Every loop over the words is unrolled, so each index is a constant and a
// set stays in registers; on_path picks d's word with a chain of selects,
// and a pop scans the words from one end for the first that is not empty.
struct DofSet {
  uint32_t w[MASK_WORDS];
};
ENG_HD DofSet anc_path(const Tables& t, int i) {
  DofSet p;
  p.w[0] = t.anc_mask[i];
  ENG_UNROLL
  for (int k = 1; k < MASK_WORDS; ++k) p.w[k] = t.anc_mask_hi[(k - 1) * MAX_BODIES + i];
  return p;
}
ENG_HD DofSet dofs_at(const uint32_t* a, int j) {
  DofSet p;
  ENG_UNROLL
  for (int k = 0; k < MASK_WORDS; ++k) p.w[k] = a[MASK_WORDS * j + k];
  return p;
}
ENG_HD DofSet dofs_none() { return DofSet{}; }
ENG_HD bool on_path(DofSet p, int d) {
  const int k = d >> 5;
  uint32_t w = p.w[0];
  ENG_UNROLL
  for (int j = 1; j < MASK_WORDS; ++j) w = k == j ? p.w[j] : w;
  return ((w >> (d & 31)) & 1u) != 0;
}
ENG_HD bool dofs_any(DofSet p) {
  uint32_t a = 0u;
  ENG_UNROLL
  for (int k = 0; k < MASK_WORDS; ++k) a |= p.w[k];
  return a != 0u;
}
ENG_HD int dofs_count(DofSet p) {
  int n = 0;
  ENG_UNROLL
  for (int k = 0; k < MASK_WORDS; ++k) n += popc32(p.w[k]);
  return n;
}
ENG_HD DofSet dofs_and_not(DofSet a, DofSet b) {
  DofSet r;
  ENG_UNROLL
  for (int k = 0; k < MASK_WORDS; ++k) r.w[k] = a.w[k] & ~b.w[k];
  return r;
}
ENG_HD int dofs_pop_high(DofSet& p) {
  int d = 0;
  bool found = false;
  ENG_UNROLL
  for (int k = MASK_WORDS - 1; k >= 0; --k) {
    if (!found && p.w[k] != 0u) {
      const int b = high_bit(p.w[k]);
      p.w[k] &= ~(1u << b);
      d = 32 * k + b;
      found = true;
    }
  }
  return d;
}
ENG_HD int dofs_pop_low(DofSet& p) {
  int d = 0;
  bool found = false;
  ENG_UNROLL
  for (int k = 0; k < MASK_WORDS; ++k) {
    if (!found && p.w[k] != 0u) {
      d = 32 * k + low_bit(p.w[k]);
      p.w[k] &= p.w[k] - 1u;
      found = true;
    }
  }
  return d;
}
#endif

// Pointers of one env-step launch; every array is (rows, B) batch-trailing.
struct EnvIO {
  const float* q;
  const float* v;
  const float* act;
  const float* aux;
  const uint8_t* term;
  const uint8_t* trunc;
  const int32_t* step_count;
  const uint32_t* epoch;
  const uint32_t* seed;
  const int32_t* env_id;
  float* q_out;
  float* v_out;
  float* obs;
  float* reward;
  uint8_t* term_out;
  uint8_t* trunc_out;
  int32_t* step_out;
  uint32_t* epoch_out;
  float* aux_out;
  float* comps;
};

// ---- lane groups ----------------------------------------------------------

// G lanes of one warp that step one env together. On the card `lane` is
// this thread's lane in the group and `mask` the group's lanes in its warp;
// on the host both are 0 and EACH_LANE loops over the lanes.
template <int G_>
struct Group {
  static constexpr int G = G_;
  static_assert(G_ >= 1 && G_ <= 32 && (G_ & (G_ - 1)) == 0, "G: a power of two <= 32");
  int lane;
  uint32_t mask;
  ENG_HD bool leader() const { return lane == 0; }
  ENG_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
};

#ifdef __CUDA_ARCH__
#define EACH_LANE(g, l) for (int l = (g).lane, l##_once = 1; l##_once; l##_once = 0)
#else
#define EACH_LANE(g, l) for (int l = 0; l < (g).G; ++l)
#endif

// Lane-private state that lives across phases: one T in each lane's
// registers on the card, one T per lane on the host.
template <class T, int G>
struct PerLane {
#ifdef __CUDA_ARCH__
  T x;
  __device__ __forceinline__ T& operator[](int) { return x; }
#else
  T x[G];
  T& operator[](int l) { return x[l]; }
#endif
};

// A vector over dofs held by the group in K chunks: lane l keeps d = l + k*G
// in x[k]. At most lane_chunks<G>() chunks: on the card for the library's
// lane_nv<G>() dofs (the launch refuses more); the host twin emulates any
// model at any G.
template <int G>
constexpr int lane_chunks() {
#ifdef __CUDACC__
  return (lane_nv<G>() + G - 1) / G;
#else
  return (MAX_NV + G - 1) / G;
#endif
}
template <int K>
struct LaneVec {
  float x[K];
};

// The sum of the lanes' partials: the xor butterfly, offsets G/2 .. 1, each
// lane adding its partner's value to its own. Every lane ends with the same
// bits (a + b == b + a), and the host replays the card's order.
#ifndef __CUDA_ARCH__
// The butterflies the host twin has run (a group_sum, group_sum2 or
// group_sum4 is one: its shuffles overlap on the card), so that a test can
// count a sweep's dependent group sums; the card keeps no count.
inline long long& host_group_sums() {
  static long long n = 0;
  return n;
}
template <int G>
float host_butterfly(const PerLane<float, G>& part) {
  float s[G];
  for (int l = 0; l < G; ++l) s[l] = part.x[l];
  for (int o = G / 2; o > 0; o >>= 1) {
    float n[G];
    for (int l = 0; l < G; ++l) n[l] = s[l] + s[l ^ o];
    for (int l = 0; l < G; ++l) s[l] = n[l];
  }
  return s[0];
}
#endif

template <int G>
ENG_HD float group_sum(const Group<G>& g, PerLane<float, G>& part) {
#ifdef __CUDA_ARCH__
  float s = part.x;
  ENG_UNROLL
  for (int o = G / 2; o > 0; o >>= 1) s = s + __shfl_xor_sync(g.mask, s, o);
  return s;
#else
  (void)g;
  ++host_group_sums();
  return host_butterfly(part);
#endif
}

// ---- scalar helpers --------------------------------------------------------

// Products and sums that must round exactly as the plain version's separate
// tensor ops do (the reset draws are compared bitwise): never contracted.
ENG_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
ENG_HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

// jnp.maximum / jnp.minimum / jnp.clip semantics: NaN propagates.
ENG_HD float jmax(float a, float b) { return (a != a || a > b) ? a : b; }
ENG_HD float jmin(float a, float b) { return (a != a || a < b) ? a : b; }
ENG_HD float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }
ENG_HD float jsign(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }
ENG_HD bool finite(float x) { return (x == x) && (fabsf(x) < 3.0e38f); }

// ---- small vector algebra, formula for formula as ops/smath.py -------------

struct V3 { float x, y, z; };
struct M3 { float m[9]; };
struct SV { V3 ang, lin; };            // spatial motion or force
struct Inertia { float m; V3 h; M3 I; };

ENG_HD V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
ENG_HD V3 v3_load(const float* p) { return v3(p[0], p[1], p[2]); }
ENG_HD V3 v3_zero() { return v3(0.f, 0.f, 0.f); }
ENG_HD V3 v3_add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
ENG_HD V3 v3_sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
ENG_HD V3 v3_scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
ENG_HD float v3_dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
ENG_HD V3 v3_cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

ENG_HD M3 m3_load(const float* p) {
  M3 r;
  for (int k = 0; k < 9; ++k) r.m[k] = p[k];
  return r;
}
ENG_HD M3 m3_identity() {
  M3 r;
  for (int k = 0; k < 9; ++k) r.m[k] = (k % 4 == 0) ? 1.f : 0.f;
  return r;
}
ENG_HD V3 m3_vec(const M3& a, V3 v) {
  return v3(a.m[0] * v.x + a.m[1] * v.y + a.m[2] * v.z,
            a.m[3] * v.x + a.m[4] * v.y + a.m[5] * v.z,
            a.m[6] * v.x + a.m[7] * v.y + a.m[8] * v.z);
}
ENG_HD M3 m3_mul(const M3& a, const M3& b) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.m[3 * i + j] = a.m[3 * i] * b.m[j] + a.m[3 * i + 1] * b.m[3 + j] +
                       a.m[3 * i + 2] * b.m[6 + j];
  return r;
}
ENG_HD M3 m3_transpose(const M3& a) {
  M3 r;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[3 * i + j] = a.m[3 * j + i];
  return r;
}

// smath.m3_from_quat of (w, x, y, z)
ENG_HD M3 m3_from_quat(const float* qt) {
  const float w = qt[0], x = qt[1], y = qt[2], z = qt[3];
  const float x2 = x + x, y2 = y + y, z2 = z + z;
  const float xx = x * x2, yy = y * y2, zz = z * z2;
  const float xy = x * y2, xz = x * z2, yz = y * z2;
  const float wx = w * x2, wy = w * y2, wz = w * z2;
  M3 r = {{1.f - (yy + zz), xy - wz, xz + wy,
           xy + wz, 1.f - (xx + zz), yz - wx,
           xz - wy, yz + wx, 1.f - (xx + yy)}};
  return r;
}

// q <- quat_normalize(exp(dt/2 * omega) * q), omega in the world frame:
// smath.quat_integrate, with its series branch for small angles.
ENG_HD void quat_integrate(float* qt, V3 omega, float dt) {
  const V3 ang = v3_scale(omega, dt);
  const float theta2 = v3_dot(ang, ang);
  const float theta = sqrtf(theta2 + 1e-20f);
  const float half = 0.5f * theta;
  const float k = theta2 > 1e-12f ? sinf(half) / theta : 0.5f - theta2 / 48.f;
  const float aw = cosf(half), ax = ang.x * k, ay = ang.y * k, az = ang.z * k;
  const float bw = qt[0], bx = qt[1], by = qt[2], bz = qt[3];
  const float w = aw * bw - ax * bx - ay * by - az * bz;
  const float x = aw * bx + ax * bw + ay * bz - az * by;
  const float y = aw * by - ax * bz + ay * bw + az * bx;
  const float z = aw * bz + ax * by - ay * bx + az * bw;
  const float inv = 1.f / sqrtf(w * w + x * x + y * y + z * z + 1e-12f);
  qt[0] = w * inv;
  qt[1] = x * inv;
  qt[2] = y * inv;
  qt[3] = z * inv;
}

ENG_HD SV sv_zero() { SV r = {v3_zero(), v3_zero()}; return r; }
ENG_HD SV sv_add(const SV& a, const SV& b) {
  SV r = {v3_add(a.ang, b.ang), v3_add(a.lin, b.lin)};
  return r;
}
ENG_HD SV sv_sub(const SV& a, const SV& b) {
  SV r = {v3_sub(a.ang, b.ang), v3_sub(a.lin, b.lin)};
  return r;
}
ENG_HD SV sv_scale(const SV& a, float s) {
  SV r = {v3_scale(a.ang, s), v3_scale(a.lin, s)};
  return r;
}
ENG_HD float sv_dot(const SV& a, const SV& b) {
  return v3_dot(a.ang, b.ang) + v3_dot(a.lin, b.lin);
}
ENG_HD SV sv_cross_motion(const SV& v, const SV& m) {
  SV r = {v3_cross(v.ang, m.ang),
          v3_add(v3_cross(v.ang, m.lin), v3_cross(v.lin, m.ang))};
  return r;
}
ENG_HD SV sv_cross_force(const SV& v, const SV& f) {
  SV r = {v3_add(v3_cross(v.ang, f.ang), v3_cross(v.lin, f.lin)),
          v3_cross(v.ang, f.lin)};
  return r;
}
// motion -> force: (I_o w + h x v_o, m v_o - h x w)
ENG_HD SV inertia_mul(const Inertia& I, const SV& v) {
  SV r = {v3_add(m3_vec(I.I, v.ang), v3_cross(I.h, v.lin)),
          v3_sub(v3_scale(v.lin, I.m), v3_cross(I.h, v.ang))};
  return r;
}

// A product operand as the probe sees it: x rounded to bf16 (to nearest,
// ties to even) under ENG_BF16_PROBE, else x.
ENG_HD float mm_operand(float x) {
#ifdef ENG_BF16_PROBE
  uint32_t u;
  memcpy(&u, &x, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&x, &u, 4);
#endif
  return x;
}
ENG_HD SV mm_operand(const SV& a) {
  SV r = {v3(mm_operand(a.ang.x), mm_operand(a.ang.y), mm_operand(a.ang.z)),
          v3(mm_operand(a.lin.x), mm_operand(a.lin.y), mm_operand(a.lin.z))};
  return r;
}
ENG_HD V3 mm_operand(V3 a) { return v3(mm_operand(a.x), mm_operand(a.y), mm_operand(a.z)); }

// ---- Cephes atan/atan2, exactly as ops/smath.py ----------------------------

ENG_HD float s_atan(float x) {
  const float PI_2 = (float)1.5707963267948966, PI_4 = (float)0.7853981633974483;
  float ax = fabsf(x);
  bool big = ax > (float)2.414213562373095;
  bool mid = ax > (float)0.4142135623730950;
  float safe = ax > (float)1e-30 ? ax : (float)1e-30;
  float z = big ? -1.f / safe : (mid ? (ax - 1.f) / (ax + 1.f) : ax);
  float off = big ? PI_2 : (mid ? PI_4 : 0.f);
  float zz = z * z;
  float y = (((float)8.05374449538e-2 * zz - (float)1.38776856032e-1) * zz +
             (float)1.99777106478e-1) * zz - (float)3.33329491539e-1;
  y = y * zz * z + z;
  return jsign(x) * (off + y);
}

ENG_HD float s_atan2(float y, float x) {
  const float PI = (float)3.141592653589793, PI_2 = (float)1.5707963267948966;
  float safe_x = fabsf(x) > (float)1e-30 ? x : (float)1e-30;
  float base = s_atan(y / safe_x);
  float shift = x < 0.f ? (y >= 0.f ? PI : -PI) : 0.f;
  float out = base + shift;
  if (fabsf(x) <= (float)1e-30) return y >= 0.f ? PI_2 : -PI_2;
  return out;
}

// ---- Threefry-2x32 (20 rounds), bitwise as ops/rand.py ---------------------

ENG_HD uint32_t rotl32(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

ENG_HD uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  for (int block = 0; block < 5; ++block) {
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, ROT[block % 2][r]) ^ x0;
    }
    int inj = block + 1;
    x0 += ks[inj % 3];
    x1 += ks[(inj + 1) % 3] + (uint32_t)inj;
  }
  return x0;
}

// U[lo, lo + span): 24-bit mantissa, then lo + span * u, each rounded once.
ENG_HD float uniform(uint32_t seed, uint32_t stream, uint32_t env_id, uint32_t epoch,
                     float lo, float span) {
  uint32_t b = threefry_bits(seed, stream, env_id, epoch);
  float u = mul_rn((float)(int32_t)(b >> 8), 5.9604644775390625e-08f);  // 2^-24
  return add_rn(lo, mul_rn(span, u));
}

// The counter of a Flagrun flag or FlagrunHarder cube draw: rand.py ·
// hash_epoch, uint32 arithmetic wrapping mod 2^32.
ENG_HD uint32_t hash_epoch(uint32_t epoch, float count) {
  return epoch * 2654435761u + (uint32_t)(int32_t)count * 0x9E3779B9u;
}

// ---- the per-env scratch -----------------------------------------------------

// Body frames, velocities, COMs and dof subspaces of one FK pass.
struct FK {
  M3* R;
  V3* p;
  SV* vel;
  V3* com;
  SV* S;
};

// Pointers into one env's scratch (Tables::sc gives each array's offset).
// inert, avp, f and obs share the space of the constraint rows Y (rows 1..),
// which are written only after the CRBA and read only before the outputs.
struct Scr {
  float *q, *v, *tau, *act, *aux, *obs;
  FK fk;
  Inertia* inert;
  SV *avp, *f;
  float *L, *inv_diag, *depth;
  V3 *P, *dirs;
  float *z, *zp, *v3o, *vp, *Y;
  float *dinv, *b_vel, *b_pos, *dinv_l, *b_l;
  float *lam_n, *lam_t1, *lam_t2, *lam_p, *lam_l;
  int32_t* dofs;  // the dof records (dofs_fill)
  float *crow, *lrow;  // the PGS scalars by row (CRow, LRow)
};

ENG_HD Scr scratch(const Tables& t, float* base) {
  const int32_t* o = t.sc;
  Scr s;
  s.q = base + o[SC_q];
  s.v = base + o[SC_v];
  s.tau = base + o[SC_tau];
  s.act = base + o[SC_act];
  s.aux = base + o[SC_aux];
  s.obs = base + o[SC_obs];
  s.fk.R = (M3*)(base + o[SC_R]);
  s.fk.p = (V3*)(base + o[SC_p]);
  s.fk.vel = (SV*)(base + o[SC_vel]);
  s.fk.com = (V3*)(base + o[SC_com]);
  s.fk.S = (SV*)(base + o[SC_S]);
  s.inert = (Inertia*)(base + o[SC_inert]);
  s.avp = (SV*)(base + o[SC_avp]);
  s.f = (SV*)(base + o[SC_f]);
  s.L = base + o[SC_L];
  s.inv_diag = base + o[SC_inv_diag];
  s.depth = base + o[SC_depth];
  s.P = (V3*)(base + o[SC_P]);
  s.dirs = (V3*)(base + o[SC_dirs]);
  s.z = base + o[SC_z];
  s.zp = base + o[SC_zp];
  s.v3o = base + o[SC_v3o];
  s.vp = base + o[SC_vp];
  s.Y = base + o[SC_Y];
  s.dinv = base + o[SC_dinv];
  s.b_vel = base + o[SC_b_vel];
  s.b_pos = base + o[SC_b_pos];
  s.dinv_l = base + o[SC_dinv_l];
  s.b_l = base + o[SC_b_l];
  s.lam_n = base + o[SC_lam_n];
  s.lam_t1 = base + o[SC_lam_t1];
  s.lam_t2 = base + o[SC_lam_t2];
  s.lam_p = base + o[SC_lam_p];
  s.lam_l = base + o[SC_lam_l];
  s.dofs = (int32_t*)(base + o[SC_dofs]);
  s.crow = base + o[SC_crow];
  s.lrow = base + o[SC_lrow];
  return s;
}

// ---- forward kinematics ------------------------------------------------------

ENG_HD M3 rodrigues(V3 u, float th) {
  float s = sinf(th);
  float c = 1.f - cosf(th);
  float ux = u.x, uy = u.y, uz = u.z;
  M3 r;
  r.m[0] = 1.f - c * (uy * uy + uz * uz);
  r.m[1] = -s * uz + c * ux * uy;
  r.m[2] = s * uy + c * ux * uz;
  r.m[3] = s * uz + c * ux * uy;
  r.m[4] = 1.f - c * (ux * ux + uz * uz);
  r.m[5] = -s * ux + c * uy * uz;
  r.m[6] = -s * uy + c * ux * uz;
  r.m[7] = s * ux + c * uy * uz;
  r.m[8] = 1.f - c * (ux * ux + uy * uy);
  return r;
}

// World-frame FK, motion subspaces, body velocities and (if `inert` is not
// null) origin-frame spatial inertias. dynamics.py · forward_kinematics.
// Body-recursive: one lane runs it.
ENG_HD void forward_kinematics(const Tables& t, const float* q, const float* v, const FK& fk,
                               Inertia* inert) {
  for (int i = 0; i < t.nb; ++i) {
    const int par = t.parent[i];
    M3 Rp = par < 0 ? m3_identity() : fk.R[par];
    V3 pp = par < 0 ? v3_zero() : fk.p[par];
    SV vp = par < 0 ? sv_zero() : fk.vel[par];
    const int d = t.v_adr[i];
    M3 Ri;
    V3 pi;
    SV vel;
    if (t.jtype[i] == JT_FREE) {
      // root-level (the MJCF loader enforces it): no frame offset; the six
      // dofs' subspaces are R's columns, angular ones about the origin
      const int qa = t.q_adr[i];
      pi = v3(q[qa], q[qa + 1], q[qa + 2]);
      Ri = m3_from_quat(q + qa + 3);
      vel = vp;
      for (int k = 0; k < 3; ++k) {
        V3 col = v3(Ri.m[k], Ri.m[3 + k], Ri.m[6 + k]);
        SV S = {col, v3_cross(pi, col)};
        fk.S[d + k] = S;
        vel = sv_add(vel, sv_scale(S, v[d + k]));
      }
      for (int k = 0; k < 3; ++k) {
        SV S = {v3_zero(), v3(Ri.m[k], Ri.m[3 + k], Ri.m[6 + k])};
        fk.S[d + 3 + k] = S;
        vel = sv_add(vel, sv_scale(S, v[d + 3 + k]));
      }
    } else {
      M3 R0 = m3_mul(Rp, m3_load(t.off_r + 9 * i));
      V3 p0 = v3_add(pp, m3_vec(Rp, v3_load(t.off_p + 3 * i)));
      SV S;
      if (t.jtype[i] == JT_HINGE) {
        float th = q[t.q_adr[i]] - t.jref[i];
        V3 a = v3_add(p0, m3_vec(R0, v3_load(t.jpos + 3 * i)));
        V3 u = m3_vec(R0, v3_load(t.jaxis + 3 * i));
        M3 Rj = rodrigues(u, th);
        Ri = m3_mul(Rj, R0);
        pi = v3_add(a, m3_vec(Rj, v3_sub(p0, a)));
        S.ang = u;
        S.lin = v3_cross(a, u);
      } else {  // JT_SLIDE
        V3 u = m3_vec(R0, v3_load(t.jaxis + 3 * i));
        Ri = R0;
        pi = v3_add(p0, v3_scale(u, q[t.q_adr[i]] - t.jref[i]));
        S.ang = v3_zero();
        S.lin = u;
      }
      fk.S[d] = S;
      vel = sv_add(vp, sv_scale(S, v[d]));
    }
    fk.vel[i] = vel;
    fk.R[i] = Ri;
    fk.p[i] = pi;
    if (t.has_mass[i]) {
      V3 c = v3_add(pi, m3_vec(Ri, v3_load(t.com + 3 * i)));
      fk.com[i] = c;
      if (inert) {
        // I_o = R I_c R^T + m (|c|^2 E - c c^T); smath.inertia_from_body
        M3 icw = m3_mul(Ri, m3_mul(m3_load(t.inertia + 9 * i), m3_transpose(Ri)));
        const float mass = t.mass[i];
        float c2 = v3_dot(c, c);
        float cc[3] = {c.x, c.y, c.z};
        Inertia In;
        In.m = mass;
        In.h = v3_scale(c, mass);
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) {
            float para = (a == b ? c2 : 0.f) - cc[a] * cc[b];
            In.I.m[3 * a + b] = icw.m[3 * a + b] + para * mass;
          }
        inert[i] = In;
      }
    } else {
      fk.com[i] = pi;
      if (inert) {
        Inertia In;
        In.m = 0.f;
        In.h = v3_zero();
        for (int k = 0; k < 9; ++k) In.I.m[k] = 0.f;
        inert[i] = In;
      }
    }
  }
}

// ---- dynamics: RNE bias, CRBA, Cholesky and its solves ---------------------

// C(q, qd), world-frame RNE with the gravity trick, into Cq (nv).
// dynamics.py · bias_forces. Body-recursive: one lane runs it.
ENG_HD void bias_forces(const Tables& t, const FK& fk, const Inertia* inert, SV* avp, SV* f,
                        float* Cq) {
  SV a0 = {v3_zero(), v3_load(t.gravity_neg)};
  for (int i = 0; i < t.nb; ++i) {
    const int par = t.parent[i];
    const SV ap = par < 0 ? a0 : avp[par];
    SV parent_vel = par < 0 ? sv_zero() : fk.vel[par];
    SV vj = sv_sub(fk.vel[i], parent_vel);
    avp[i] = sv_add(ap, sv_cross_motion(fk.vel[i], vj));
    SV hi = inertia_mul(inert[i], fk.vel[i]);
    f[i] = sv_add(inertia_mul(inert[i], avp[i]), sv_cross_force(fk.vel[i], hi));
  }
  for (int i = t.nb - 1; i >= 0; --i)
    if (t.parent[i] >= 0) f[t.parent[i]] = sv_add(f[t.parent[i]], f[i]);
  for (int d = 0; d < t.nv; ++d)
    Cq[d] = sv_dot(mm_operand(fk.S[d]), mm_operand(f[t.dof_body[d]]));
}

// CRBA's composite inertias, summed leafwise in place (dynamics.py ·
// mass_matrix); the composite masses come from the tables. One lane.
ENG_HD void composite_inertias(const Tables& t, Inertia* Ic) {
  for (int i = t.nb - 1; i >= 0; --i) {
    const int par = t.parent[i];
    if (par >= 0) {
      Ic[par].h = v3_add(Ic[par].h, Ic[i].h);
      for (int k = 0; k < 9; ++k) Ic[par].I.m[k] = Ic[par].I.m[k] + Ic[i].I.m[k];
    }
  }
}

// ---- M = L^T L over the dof tree --------------------------------------------
// Featherstone's LTL factorization ("Efficient factorization of the
// joint-space inertia matrix for branched kinematic trees", IJRR 2005;
// MuJoCo factors M the same way): from the last dof to the first, each
// dof's row is scaled by its diagonal and folded into its ancestors' rows.
// Parents come before children, so nothing fills in and L is stored by
// ancestor rows (Tables::anc_row; Atlas's 351 floats against the dense
// 1,332). M^-1 = L^-1 L^-T, so the square-root-space PGS runs on z = L v +
// dt L^-T rhs and the rows Y_r = L^-T J_r^T (Y^T Y is J M^-1 J^T, as the
// plain version's L^-1 J^T of M = L L^T gives it: the PGS iterates are the
// plain version's up to rounding), and v = L^-1 z. A dof off a row's
// support has no descendant on it, so L^-T of the row stays on the support:
// its solve, storage, set-up and sweeps run over the support only. The
// sums are not in the plain version's order (its dense Cholesky's): the
// kernels hold its budgets, not its bits.

// A constraint row's support (Tables::path_u) and where the row's
// forward-solved entries sit: a dof of body a's path (a chain; a limit
// row's: its dof's chain) at its depth, positions 0 .. |a| - 1; a dof of
// body b's path only (`bo`; pair rows) at its depth plus na. y: the row's
// offset in Y.
struct PathRow {
  DofSet a, bo, u;  // a's path, b's less a's, the support (their union)
  int na, n, y;     // |a's path - b's path|, the support's size, Y offset
};
// Row j's table words (RowRaw, a pair row's with its body a's: PAIR), and
// its PathRow from them: two steps, so that the PGS sweep can read a row's
// words a row before it derives anything from them (sweep_rows)
struct RowRaw {
  int y, na;
  DofSet u, a;
  float c;  // the sweep's constant: a contact row's mu, a limit row's sign
  // a limit step's rows (limit_raw): its first limit row m, 2 where the
  // step is a pair (the second row's sign c2), else 1
  int m, step;
  float c2;
};
template <bool PAIR>
ENG_HD RowRaw row_raw(const Tables& t, int j) {
  RowRaw w;
  w.y = t.path_y[j];
  w.u = dofs_at(t.path_u, j);
  w.na = 0;
  w.a = dofs_none();
  w.c = j < t.nr ? t.row_mu[j] : t.lim_sign[j - t.nr];
  w.m = 0;
  w.step = 1;
  w.c2 = 0.f;
  if (PAIR) {
    const int k = j - (t.nr - t.npair);
    w.a = dofs_at(t.pair_pa, k);
    w.na = t.pair_na[k];
  }
  return w;
}
template <bool PAIR>
ENG_HD PathRow row_of(const RowRaw& w) {
  PathRow p;
  p.y = w.y;
  p.u = w.u;
  p.n = dofs_count(w.u);
  if (PAIR) {
    p.a = w.a;
    p.na = w.na;
    p.bo = dofs_and_not(w.u, w.a);
  } else {
    p.a = w.u;
    p.na = p.n;
    p.bo = dofs_none();
  }
  return p;
}
// row j: contact row j (j < nr), or limit row j - nr
ENG_HD PathRow row_path(const Tables& t, int j) {
  return j >= t.nr - t.npair && j < t.nr ? row_of<true>(row_raw<true>(t, j))
                                         : row_of<false>(row_raw<false>(t, j));
}
// The rows of limit step k (Tables::lim_first): a row, or a pair of one
// dof's two rows, which share one Y row (ops/cuda_engine.py ·
// limit_seconds) and are solved, set up and swept as one
ENG_HD int limit_step_rows(const Tables& t, int k) {
  return (k + 1 < t.lim_steps ? t.lim_first[k + 1] : t.nl) - t.lim_first[k];
}
// limit step k's words: its first row's, its rows and the second's sign
ENG_HD RowRaw limit_raw(const Tables& t, int k) {
  const int m = t.lim_first[k];
  RowRaw w = row_raw<false>(t, t.nr + m);
  w.m = m;
  w.step = limit_step_rows(t, k);
  w.c2 = t.lim_sign[m + w.step - 1];
  return w;
}
// Dof d's ancestor row in L, the model's dof (dof_perm), its depth and its
// ancestors: DOF_WORDS words a dof in the scratch's `dofs` (copied by
// dofs_fill once a launch: the substep reads them at lane-divergent
// indices). The default class packs the row in the low 16 bits of word 0,
// the model's dof above, then the depth and two mask words; the global
// classes (no cap on L or nv): the row, the depth, the model's dof, then
// MASK_WORDS mask words.
struct DofPath {
  int row, model, depth;
  DofSet anc;
};
#ifndef ENG_GLOBAL_TABLES
constexpr int DOF_WORDS = 4;
ENG_HD DofPath dof_path(const Scr& s, int d) {
  const int32_t* q = s.dofs + 4 * d;
  DofPath p = {q[0] & 0xffff, q[0] >> 16, q[1], {(uint32_t)q[2], (uint32_t)q[3]}};
  return p;
}
// the model's dof of dof d, and the offset of its row of L
ENG_HD int dof_model(const Scr& s, int d) { return s.dofs[4 * d] >> 16; }
ENG_HD int dof_row(const Scr& s, int d) { return s.dofs[4 * d] & 0xffff; }
// the lanes over dofs; the caller's next g.sync() ends the phase
template <int G>
ENG_HD void dofs_fill(const Tables& t, const Group<G>& g, const Scr& s) {
  EACH_LANE(g, l) {
    for (int d = l; d < t.nv; d += G) {
      int32_t* q = s.dofs + 4 * d;
      q[0] = t.anc_row[d] | t.dof_perm[d] << 16;
      q[1] = t.dof_depth[d];
      q[2] = (int32_t)t.dof_anc[2 * d];
      q[3] = (int32_t)t.dof_anc[2 * d + 1];
    }
  }
}
// the lowest dof that can be an ancestor of dof k
ENG_HD int anc_lo(const Tables&, int) { return 0; }
#else
constexpr int DOF_WORDS = 3 + MASK_WORDS;
ENG_HD DofPath dof_path(const Scr& s, int d) {
  const int32_t* q = s.dofs + DOF_WORDS * d;
  DofPath p;
  p.row = q[0];
  p.depth = q[1];
  p.model = q[2];
  p.anc = dofs_at((const uint32_t*)q + 3, 0);
  return p;
}
ENG_HD int dof_model(const Scr& s, int d) { return s.dofs[DOF_WORDS * d + 2]; }
ENG_HD int dof_row(const Scr& s, int d) { return s.dofs[DOF_WORDS * d]; }
template <int G>
ENG_HD void dofs_fill(const Tables& t, const Group<G>& g, const Scr& s) {
  EACH_LANE(g, l) {
    for (int d = l; d < t.nv; d += G) {
      int32_t* q = s.dofs + DOF_WORDS * d;
      q[0] = t.anc_row[d];
      q[1] = t.dof_depth[d];
      q[2] = t.dof_perm[d];
      for (int k = 0; k < MASK_WORDS; ++k) q[3 + k] = (int32_t)t.dof_anc[MASK_WORDS * d + k];
    }
  }
}
// the lowest dof that can be an ancestor of dof k: a model of many trees
// bounds the factorization's lanes by k's tree
ENG_HD int anc_lo(const Tables& t, int k) { return t.dof_lo[k]; }
#endif
// dof d's depth: its ancestors
ENG_HD int dof_depth(const Scr& s, int d) { return s.dofs[DOF_WORDS * d + 1]; }

// Row k of M over k's ancestors and k (its ancestor row, root first), each
// entry as mass_matrix computes it for the model's dofs; one lane a row.
ENG_HD void mass_matrix_row(const Tables& t, const Scr& s, int k) {
  const DofPath pk = dof_path(s, k);
  const int d = pk.model, i = t.dof_body[d];
  Inertia I = s.inert[i];
  I.m = t.cmass[i];
  const SV F = inertia_mul(I, s.fk.S[d]);
  float* const Md = s.L + pk.row;
  DofSet anc = pk.anc;
  for (int m = 0; dofs_any(anc); ++m) {
    const int e = dof_model(s, dofs_pop_low(anc));
    Md[m] = sv_dot(mm_operand(s.fk.S[e]), mm_operand(F));
  }
  Md[pk.depth] = sv_dot(mm_operand(s.fk.S[d]), mm_operand(F));
  if (t.armature[d] != 0.f) Md[pk.depth] = Md[pk.depth] + t.armature[d];
}

// The registers of a row in path_solve_t: the longest support the library
// takes (a library of G lanes takes at most lane_nv<G>() dofs); the host
// twin emulates any model at any G
template <int G>
constexpr int path_regs() {
#ifdef __CUDACC__
  return lane_nv<G>() < PATH_CAP ? lane_nv<G>() : PATH_CAP;
#else
  return PATH_CAP;
#endif
}

// The factorization in place over M's ancestor rows (mass_matrix_row), and
// the dynamics' right-hand side y (Y's row 0) to L^-T y beside it. Dof k's
// step subtracts H(k, i) H(k, j) / H(k, k) from each ancestor i's row (j
// its ancestors and i; four entries at a time loaded into registers, then
// stored, so that their loads do not wait on stores) and L(k, i) x_k from
// y_i, the lanes over the dofs below k (each its own dof's row, if an
// ancestor of k: at most k's depth, 15 on Atlas), one g.sync() a dof. Each
// row's off-diagonal entries are scaled by 1 / L(k, k) in the next step,
// which no longer reads them.
template <int G>
ENG_HD void ltl_factor(const Tables& t, const Group<G>& g, const Scr& s) {
  float* const L = s.L;
  float* const y = s.Y;
  for (int k = t.nv - 1; k >= 0; --k) {
    const DofPath pk = dof_path(s, k);
    float* const Lk = L + pk.row;
    const float dkk = sqrtf(jmax(Lk[pk.depth], (float)1e-9));
    const float inv = 1.f / dkk;
    const float inv2 = inv * inv;
    const float x = y[k] * inv;
    EACH_LANE(g, l) {
      for (int i = anc_lo(t, k) + l; i < k; i += G) {  // lanes over dofs: k's ancestors
        if (!on_path(pk.anc, i)) continue;
        const int m = dof_depth(s, i);  // i's depth: H(k, i) at Lk[m]
        float* const Li = L + dof_row(s, i);
        const float hkm = Lk[m];
        const float a = hkm * inv2;
        for (int j0 = 0; j0 <= m; j0 += 4) {
          float li[4];
          ENG_UNROLL
          for (int q = 0; q < 4; ++q)
            if (j0 + q <= m) li[q] = Li[j0 + q] - a * Lk[j0 + q];
          ENG_UNROLL
          for (int q = 0; q < 4; ++q)
            if (j0 + q <= m) Li[j0 + q] = li[q];
        }
        y[i] = y[i] - (hkm * inv) * x;
      }
      if (k + 1 < t.nv) {
        const DofPath pn = dof_path(s, k + 1);
        const float in = s.inv_diag[k + 1];
        for (int m = l; m < pn.depth; m += G) L[pn.row + m] = L[pn.row + m] * in;
      }
    }
    Lk[pk.depth] = dkk;  // uniform: every lane stores the same bits
    s.inv_diag[k] = inv;
    y[k] = x;
    g.sync();
  }
}

// x = L^-1 z: from the root, each entry less its ancestors' terms, x by
// the model's dofs. One lane.
ENG_HD void ltl_solve(const Tables& t, const Scr& s, const float* z, float* x) {
  for (int i = 0; i < t.nv; ++i) {
    const DofPath pi = dof_path(s, i);
    const float* const Li = s.L + pi.row;
    float a = z[i];
    DofSet anc = pi.anc;
    for (int m = 0; dofs_any(anc); ++m) a = a - Li[m] * x[dof_model(s, dofs_pop_low(anc))];
    x[pi.model] = a * s.inv_diag[i];
  }
}

// the position of dof d (depth dd) of the support in the row
ENG_HD int path_pos(const PathRow& p, int d, int dd) { return on_path(p.bo, d) ? dd + p.na : dd; }

// y = L^-T y for a right-hand side on a row's support, stored by position
// (PathRow), in P registers: positions from the last to the first, each
// solved entry subtracted from its ancestors' positions. Every index is a
// constant, so the row stays in registers. A pair row (PAIR) keeps b's
// dofs above a's path: their ancestors are the dofs of a's path that b
// shares (positions below c) and b's own earlier ones (at depth + na).
template <int P, bool PAIR>
ENG_HD void path_solve_t(const Scr& s, const PathRow& p, float* y) {
  const int n = p.n, nab = n - dofs_count(p.bo);  // |a's path|
  const int c = nab - p.na;
  DofSet wa = p.a, wb = p.bo;
  float x[P];
  ENG_UNROLL
  for (int j = 0; j < P; ++j) x[j] = j < n ? y[j] : 0.f;
  ENG_UNROLL
  for (int j = P - 1; j >= 0; --j) {
    if (j < n) {
      const bool in_b = PAIR && j >= nab;
      const int d = in_b ? dofs_pop_high(wb) : dofs_pop_high(wa);
      const float xj = x[j] * s.inv_diag[d];
      x[j] = xj;
      const float* const Ld = s.L + dof_row(s, d);
      ENG_UNROLL
      for (int m = 0; m < j; ++m) {
        if (in_b && m >= c && m < nab) continue;  // a's dofs off b's path
        x[m] = x[m] - Ld[m >= nab ? m - p.na : m] * xj;
      }
    }
  }
  ENG_UNROLL
  for (int j = 0; j < P; ++j)
    if (j < n) y[j] = x[j];
}

#ifdef ENG_GLOBAL_TABLES
// path_solve_t of a support past PATH_CAP in the scratch, y in place, the
// same operations in order. Not inlined: beside path_solve_t it cost the
// physics builds 20-56 B of spills at their 128 registers (ptxas, sm_90a).
template <bool PAIR>
#ifdef __CUDA_ARCH__
__device__ __noinline__
#else
inline
#endif
void path_solve_mem(const Scr& s, const PathRow& p, float* y) {
  const int n = p.n, nab = n - dofs_count(p.bo);
  const int c = nab - p.na;
  DofSet wa = p.a, wb = p.bo;
  for (int j = n - 1; j >= 0; --j) {
    const bool in_b = PAIR && j >= nab;
    const int d = in_b ? dofs_pop_high(wb) : dofs_pop_high(wa);
    const float xj = y[j] * s.inv_diag[d];
    y[j] = xj;
    const float* const Ld = s.L + dof_row(s, d);
    for (int m = 0; m < j; ++m) {
      if (in_b && m >= c && m < nab) continue;
      y[m] = y[m] - Ld[m >= nab ? m - p.na : m] * xj;
    }
  }
}
#endif

// A row's forward solve: in registers (path_solve_t); in the global classes
// in the scratch where its support is longer than PATH_CAP
template <int G, bool PAIR>
ENG_HD void path_solve(const Scr& s, const PathRow& p, float* y) {
#ifdef ENG_GLOBAL_TABLES
  if (p.n > PATH_CAP) {
    path_solve_mem<PAIR>(s, p, y);
    return;
  }
#endif
  path_solve_t<path_regs<G>(), PAIR>(s, p, y);
}

// sum of a[d] * b[d] in dof order (the probe's operands)
ENG_HD float dotn(int n, const float* a, const float* b) {
  float s = 0.f;
  ENG_UNROLL4
  for (int d = 0; d < n; ++d) s = s + mm_operand(a[d]) * mm_operand(b[d]);
  return s;
}

// Four independent group sums through one butterfly (each as group_sum
// computes it alone), so that their shuffles overlap
template <int G>
ENG_HD void group_sum4(const Group<G>& g, PerLane<float, G>* p, float* out) {
#ifdef __CUDA_ARCH__
  float x[4];
  ENG_UNROLL
  for (int k = 0; k < 4; ++k) x[k] = p[k].x;
  ENG_UNROLL
  for (int o = G / 2; o > 0; o >>= 1) {
    float xo[4];
    ENG_UNROLL
    for (int k = 0; k < 4; ++k) xo[k] = __shfl_xor_sync(g.mask, x[k], o);
    ENG_UNROLL
    for (int k = 0; k < 4; ++k) x[k] = x[k] + xo[k];
  }
  ENG_UNROLL
  for (int k = 0; k < 4; ++k) out[k] = x[k];
#else
  (void)g;
  ++host_group_sums();
  for (int k = 0; k < 4; ++k) out[k] = host_butterfly(p[k]);
#endif
}

// A row's entries as the PGS sweep's lanes hold them: lane l's dof of chunk
// k meets the row's entry at the dof's position (its normal's, and a
// contact row's two tangents'), 0 off the row's support, as the plain
// version's dense row holds it; loaded into registers one row ahead
// (row_regs), so that no load waits on the chain of the row before (and no
// shuffle: each lane holds its own dofs' z).
template <int K>
struct LaneInt {
  int x[K];
};
template <int K>
struct RowRegs {
  float n[K], t1[K], t2[K];
};

// Loads row p's entries (a contact row's three directions, or a limit
// row's one: THREE; a pair row's positions: PAIR) into the lanes'
// registers. A lane off the support loads the row's first entries, which
// every row has, and keeps 0: no branch.
template <int G, int K, bool THREE, bool PAIR>
ENG_HD void row_regs(const Group<G>& g, const PathRow& p, const float* Y,
                     PerLane<LaneInt<K>, G>& dep, PerLane<RowRegs<K>, G>& out) {
  EACH_LANE(g, l) {
    RowRegs<K>& o = out[l];
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      const int d = l + k * G;
      const bool on = on_path(p.u, d);
      const int pos = PAIR ? path_pos(p, d, dep[l].x[k]) : dep[l].x[k];
      const float* y = Y + p.y + (on ? pos : 0);
      const float n = y[0];
      o.n[k] = on ? n : 0.f;
      if (THREE) {
        const float t1 = y[p.n], t2 = y[2 * p.n];
        o.t1[k] = on ? t1 : 0.f;
        o.t2[k] = on ? t2 : 0.f;
      }
    }
  }
}

// The sweep's dot of a limit row with the group's vector: lane products in
// chunk order, then the butterfly; and a contact row's four dots (its normal
// with z and zp, its tangents with z), their butterflies one (group_sum4).
template <int G, int K>
ENG_HD float path_dot(const Group<G>& g, PerLane<RowRegs<K>, G>& row, PerLane<LaneVec<K>, G>& z) {
  PerLane<float, G> part;
  EACH_LANE(g, l) {
    float s = 0.f;
    ENG_UNROLL
    for (int k = 0; k < K; ++k) s = s + row[l].n[k] * z[l].x[k];
    part[l] = s;
  }
  return group_sum(g, part);
}

template <int G, int K>
ENG_HD void path_dot4(const Group<G>& g, PerLane<RowRegs<K>, G>& row, PerLane<LaneVec<K>, G>& z,
                      PerLane<LaneVec<K>, G>& zp, float* out) {
  PerLane<float, G> part[4];
  EACH_LANE(g, l) {
    const RowRegs<K>& r = row[l];
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      s[0] = s[0] + r.n[k] * z[l].x[k];
      s[1] = s[1] + r.n[k] * zp[l].x[k];
      s[2] = s[2] + r.t1[k] * z[l].x[k];
      s[3] = s[3] + r.t2[k] * z[l].x[k];
    }
    ENG_UNROLL
    for (int i = 0; i < 4; ++i) part[i][l] = s[i];
  }
  group_sum4(g, part, out);
}

// z += y * a, each lane its own dofs (y 0 off the row's support)
template <int G, int K>
ENG_HD void path_axpy(const Group<G>& g, PerLane<RowRegs<K>, G>& row, PerLane<LaneVec<K>, G>& z,
                      float a) {
  EACH_LANE(g, l) {
    ENG_UNROLL
    for (int k = 0; k < K; ++k) z[l].x[k] = z[l].x[k] + row[l].n[k] * a;
  }
}

// ---- narrowphase of one capsule/sphere pair: contacts.py · narrowphase_scalar

// Closest points of the segments, the normal from b into a, the depth, the
// midpoint of the two surface points and the per-env tangent basis.
ENG_HD void pair_contact(const Tables& t, const FK& fk, int k, float& depth, V3& mid, V3* dirs) {
  const int ba = t.pair_a[k], bb = t.pair_b[k];
  const V3 a0 = v3_add(fk.p[ba], m3_vec(fk.R[ba], v3_load(t.pair_a0 + 3 * k)));
  const V3 a1 = v3_add(fk.p[ba], m3_vec(fk.R[ba], v3_load(t.pair_a1 + 3 * k)));
  const V3 b0 = v3_add(fk.p[bb], m3_vec(fk.R[bb], v3_load(t.pair_b0 + 3 * k)));
  const V3 b1 = v3_add(fk.p[bb], m3_vec(fk.R[bb], v3_load(t.pair_b1 + 3 * k)));
  // _segment_closest, with its branchless clamps and guards
  const V3 d1 = v3_sub(a1, a0), d2 = v3_sub(b1, b0), r = v3_sub(a0, b0);
  const float a = v3_dot(d1, d1), e = v3_dot(d2, d2), f = v3_dot(d2, r);
  const float cdot = v3_dot(d1, r), b = v3_dot(d1, d2);
  const float denom = a * e - b * b;
  float s = denom > 1e-12f ? jclip((b * f - cdot * e) / (denom + 1e-20f), 0.f, 1.f) : 0.f;
  const float u = jclip((b * s + f) / (e + 1e-20f), 0.f, 1.f);
  s = jclip((b * u - cdot) / (a + 1e-20f), 0.f, 1.f);
  const V3 ca = v3_add(a0, v3_scale(d1, s)), cb = v3_add(b0, v3_scale(d2, u));
  const V3 dvec = v3_sub(ca, cb);
  const float dist = sqrtf(v3_dot(dvec, dvec) + 1e-12f);
  const V3 n = v3_scale(dvec, 1.f / dist);
  depth = t.pair_rsum[k] - dist;
  const V3 pa = v3_sub(ca, v3_scale(n, t.pair_ra[k]));
  const V3 pb = v3_add(cb, v3_scale(n, t.pair_rb[k]));
  mid = v3_add(pa, v3_scale(v3_sub(pb, pa), 0.5f));
  const V3 ref = fabsf(n.x) < 0.9f ? v3(1.f, 0.f, 0.f) : v3(0.f, 1.f, 0.f);
  const V3 c = v3_cross(n, ref);
  const V3 t1 = v3_scale(c, 1.f / sqrtf(v3_dot(c, c) + 1e-12f));
  dirs[0] = n;
  dirs[1] = t1;
  dirs[2] = v3_cross(n, t1);
}

// A disk row's offset from its end cap's centre to its rim point: the cap's
// in-plane direction e1 = (n x w)/|n x w| toward the plane, or R's first
// column where the axis w stands on the plane (|n x w|^2 <= 1e-10, as
// Pusher's upright cylinder always does), e2 = w x e1, times the signed
// radius. contacts.py · narrowphase_scalar, disk branch.
ENG_HD V3 disk_rim(const Tables& t, const M3& R, V3 n, int r) {
  const V3 w = m3_vec(R, v3_load(t.row_axis + 3 * r));
  const V3 nxw = v3_cross(n, w);
  const float deg = v3_dot(nxw, nxw);
  const float inv = 1.f / sqrtf(deg + 1e-12f);
  const V3 e1 = deg > 1e-10f ? v3_scale(nxw, inv) : v3(R.m[0], R.m[3], R.m[6]);
  const V3 e = t.row_disk[r] == 1 ? e1 : v3_cross(w, e1);
  return v3_scale(e, t.row_rim[r]);
}

// contact_step's scalar chain (below) as win_step runs it, from the row's
// four dots d and its CRow block c (a register copy): the new multipliers
// and their changes. contact_step keeps its own text: calling this chain
// from it moves the default class's SASS (PERF.md §6).
struct ContactStep {
  float lp, ap, ln, an, l1, a1, l2, a2;
};
ENG_HD ContactStep contact_chain(const float* c, float mu, const float* d) {
  ContactStep u;
  const float dn = c[CR_DINV], *gram = c + CR_GRAM;
  u.lp = jmax(c[CR_LAM_P] + (c[CR_B_POS] - d[1]) * dn, 0.f);
  u.ap = u.lp - c[CR_LAM_P];
  u.ln = jmax(c[CR_LAM_N] + (c[CR_B_VEL] - d[0]) * dn, 0.f);
  u.an = u.ln - c[CR_LAM_N];
  const float hi = mu * u.ln;
  u.l1 = jclip(c[CR_LAM_T1] - (d[2] + u.an * gram[0]) * c[CR_DINV + 1], -hi, hi);
  u.a1 = u.l1 - c[CR_LAM_T1];
  u.l2 = jclip(c[CR_LAM_T2] - ((d[3] + u.an * gram[1]) + u.a1 * gram[2]) * c[CR_DINV + 2], -hi,
               hi);
  u.a2 = u.l2 - c[CR_LAM_T2];
  return u;
}
ENG_HD void contact_store(float* c, const ContactStep& u) {
  c[CR_LAM_P] = u.lp;
  c[CR_LAM_N] = u.ln;
  c[CR_LAM_T1] = u.l1;
  c[CR_LAM_T2] = u.l2;
}

// limit_step's chain (below) as win_step runs it, from u = w.z and the LRow
// blocks r (a register copy): stores the multipliers in c, returns z's update.
ENG_HD float limit_chain(const float* r, float* c, float sign, int step, float sign2,
                         float u) {
  const float l0 = jmax(r[LR_LAM] + (r[LR_B] - sign * u) * r[LR_D], 0.f);
  float a = sign * (l0 - r[LR_LAM]);
  c[LR_LAM] = l0;
  if (step == 2) {
    const float* const r2 = r + LROW;
    const float l1 = jmax(r2[LR_LAM] + (r2[LR_B] - sign2 * (u + a * r2[LR_D])) * r[LR_D], 0.f);
    a = a + sign2 * (l1 - r2[LR_LAM]);
    c[LROW + LR_LAM] = l1;
  }
  return a;
}

// One contact row's step of a sweep (contacts.py · solve_scalar), its
// entries in the lanes' registers: one butterfly for the row's four dots
// (path_dot4), then its chain in scalars, read from the row's CRow block
// after the butterfly (read earlier, they hold registers through it, which
// cost the small models' blocks of 128 threads a block an SM on an H100).
// After the normal's update z += y_n dn, a tangent's dot is y_t1.z + dn
// (y_t1.y_n), and the second tangent's y_t2.z + dn (y_t2.y_n) + dt1
// (y_t2.y_t1): the Gram entries of the set-up give the Gauss-Seidel
// iterates of the per-direction order (other roundings). The split-impulse
// row reads and writes only zp. z takes the three updates at the row's end,
// in the order of three axpys; the multipliers are uniform (every lane
// stores the same bits).
template <int G, int K>
ENG_HD void contact_step(const Group<G>& g, const Scr& s, int r, float mu,
                         PerLane<RowRegs<K>, G>& row, PerLane<LaneVec<K>, G>& z,
                         PerLane<LaneVec<K>, G>& zp) {
  float d[4];  // y_n.z, y_n.zp, y_t1.z, y_t2.z
  path_dot4(g, row, z, zp, d);
  float* const c = s.crow + CROW * r;
  const float dn = c[CR_DINV], *gram = c + CR_GRAM;
  const float lp = jmax(c[CR_LAM_P] + (c[CR_B_POS] - d[1]) * dn, 0.f);
  const float ap = lp - c[CR_LAM_P];
  const float ln = jmax(c[CR_LAM_N] + (c[CR_B_VEL] - d[0]) * dn, 0.f);
  const float an = ln - c[CR_LAM_N];
  const float hi = mu * ln;
  const float l1 = jclip(c[CR_LAM_T1] - (d[2] + an * gram[0]) * c[CR_DINV + 1], -hi, hi);
  const float a1 = l1 - c[CR_LAM_T1];
  const float l2 =
      jclip(c[CR_LAM_T2] - ((d[3] + an * gram[1]) + a1 * gram[2]) * c[CR_DINV + 2], -hi, hi);
  const float a2 = l2 - c[CR_LAM_T2];
  EACH_LANE(g, l) {
    const RowRegs<K>& y = row[l];
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      zp[l].x[k] = zp[l].x[k] + y.n[k] * ap;
      z[l].x[k] = ((z[l].x[k] + y.n[k] * an) + y.t1[k] * a1) + y.t2[k] * a2;
    }
  }
  c[CR_LAM_P] = lp;
  c[CR_LAM_N] = ln;
  c[CR_LAM_T1] = l1;
  c[CR_LAM_T2] = l2;
}

// One limit step: a row, or a pair (limit_raw), whose rows are one w =
// L^-T e_d: one butterfly for w.z; the second row's dot is c2 (w.z + a
// |w|^2), a the first row's update; z takes the pair's update at once.
template <int G, int K>
ENG_HD void limit_step(const Group<G>& g, const Scr& s, int m, const RowRaw& w,
                       PerLane<RowRegs<K>, G>& row, PerLane<LaneVec<K>, G>& z) {
  const float u = path_dot(g, row, z);
  float* const c = s.lrow + LROW * m;  // the step's first row, then its second
  const float l0 = jmax(c[LR_LAM] + (c[LR_B] - w.c * u) * c[LR_D], 0.f);
  float a = w.c * (l0 - c[LR_LAM]);
  c[LR_LAM] = l0;
  if (w.step == 2) {
    float* const c2 = c + LROW;
    const float l1 = jmax(c2[LR_LAM] + (c2[LR_B] - w.c2 * (u + a * c2[LR_D])) * c[LR_D], 0.f);
    a = a + w.c2 * (l1 - c2[LR_LAM]);
    c2[LR_LAM] = l1;
  }
  path_axpy(g, row, z, a);
}

// Contact rows lo .. hi - 1 (pair rows: PAIR) in a sweep. Each row's
// entries are loaded into registers a row ahead (row_regs) from its table
// words, read a row before that (row_raw): no instruction of a row's chain
// waits on a load, and no load on a table read issued in the same row (a
// warp issues in order).
template <int G, int K, bool PAIR>
ENG_HD void sweep_contacts(const Tables& t, const Group<G>& g, const Scr& s, int lo, int hi,
                           PerLane<LaneInt<K>, G>& dep, PerLane<LaneVec<K>, G>& z,
                           PerLane<LaneVec<K>, G>& zp) {
  if (lo >= hi) return;
  PerLane<RowRegs<K>, G> row, next;
  const RowRaw w0 = row_raw<PAIR>(t, lo);
  row_regs<G, K, true, PAIR>(g, row_of<PAIR>(w0), s.Y, dep, row);
  float mu = w0.c;
  RowRaw w = row_raw<PAIR>(t, lo + 1 < hi ? lo + 1 : lo);
  for (int j = lo; j < hi; ++j) {
    row_regs<G, K, true, PAIR>(g, row_of<PAIR>(w), s.Y, dep, next);
    const float mu_next = w.c;
    w = row_raw<PAIR>(t, j + 2 < hi ? j + 2 : hi - 1);
    contact_step(g, s, j, mu, row, z, zp);
    row = next;
    mu = mu_next;
  }
}

// The limit steps in a sweep (limit_raw: a row, or a pair), each step's
// entries loaded a step ahead from its words, read in the step before (a
// sweep has few limit steps).
template <int G, int K>
ENG_HD void sweep_limits(const Tables& t, const Group<G>& g, const Scr& s,
                         PerLane<LaneInt<K>, G>& dep, PerLane<LaneVec<K>, G>& z) {
  const int n = t.lim_steps;
  if (n == 0) return;
  PerLane<RowRegs<K>, G> row, next;
  RowRaw cur = limit_raw(t, 0);
  row_regs<G, K, false, false>(g, row_of<false>(cur), s.Y, dep, row);
  for (int k = 0; k < n; ++k) {
    const RowRaw w = limit_raw(t, k + 1 < n ? k + 1 : k);
    row_regs<G, K, false, false>(g, row_of<false>(w), s.Y, dep, next);
    limit_step(g, s, cur.m, cur, row, z);
    row = next;
    cur = w;
  }
}

// The PGS sweeps of the default class: Gauss-Seidel over the floor rows, the
// pair rows, then the limit rows, each row's dots and updates over its
// support; z and zp (the scratch's, on entry and exit) live in the lanes'
// registers in K chunks by dof, beside each dof's depth. A contact row's
// step runs one butterfly, and so does a limit row's or a limit pair's.
template <int G, int K>
ENG_HD void pgs_sweeps(const Tables& t, const Group<G>& g, const Scr& s) {
  const int nv = t.nv, nr = t.nr, nfloor = nr - t.npair;
  PerLane<LaneVec<K>, G> z, zp;
  PerLane<LaneInt<K>, G> dep;
  EACH_LANE(g, l) {
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      const int d = l + k * G;
      z[l].x[k] = d < nv ? s.z[d] : 0.f;
      zp[l].x[k] = 0.f;
      dep[l].x[k] = d < nv ? dof_depth(s, d) : 0;
    }
  }
  for (int it = 0; it < t.iterations; ++it) {
    sweep_contacts<G, K, false>(t, g, s, 0, nfloor, dep, z, zp);
    sweep_contacts<G, K, true>(t, g, s, nfloor, nr, dep, z, zp);
    sweep_limits<G, K>(t, g, s, dep, z);
  }
  EACH_LANE(g, l) {
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      const int d = l + k * G;
      if (d < nv) {
        s.z[d] = z[l].x[k];
        s.zp[d] = zp[l].x[k];
      }
    }
  }
}

#ifdef ENG_GLOBAL_TABLES
// ---- the sweep of the global classes: a row by its window -------------------
// Their lanes hold z and zp by dof in K chunks (2 to 8 at G = 32 on two to
// ten Humanoids), as pgs_sweeps does, but a row's entries only over its
// window: the W = win_chunks chunks of the two mask words from path_w0
// (chunks from c0 = 32 w0 / G), which hold every support within a tree of up
// to 33 dofs. A chunk outside the window is skipped by the whole group, so k
// stays a constant and z a register. A row over more words (a pair row of
// two trees apart) takes its further windows in its step, its partials in
// chunk order and one butterfly all the same. Their scratch is in global
// memory, so no load is on a row's chain: its table words are read two
// rows ahead (fixed addresses), its entries a row ahead (their positions
// ranks in the window's words) and its PGS scalars at its step's start.
template <int G, int K>
constexpr int win_chunks() {
  return K < 64 / G ? K : 64 / G;
}

// Row j's words for the sweep (j: contact row j, or limit row j - nr): its
// Y offset, support size, |a| (body a's path; any other row's support),
// window's first word and last word, the support's and body a's words in
// the window, the row's mu or sign, a limit step's rows (limit_raw)
struct WinRaw {
  int j, y, n, na, w0, w1;
  uint32_t u[2], a[2];
  float c;
  int m, step;
  float c2;
};
// row j's support's and body a's words wk, wk + 1 (0 past the last word),
// and the dofs of each in the words before wk (ba, bb: a, and the support
// less a)
ENG_HD void win_words(const Tables& t, int j, int wk, uint32_t* u, uint32_t* a, int& ba,
                      int& bb) {
  const int k = j - (t.nr - t.npair);
  const bool pair = k >= 0 && j < t.nr;
  const uint32_t* pu = t.path_u + MASK_WORDS * j;
  const uint32_t* pa = t.pair_pa + MASK_WORDS * (pair ? k : 0);
  ba = bb = 0;
  for (int i = 0; i < wk; ++i) {
    const uint32_t ui = pu[i], ai = pair ? pa[i] : ui;
    ba += popc32(ai);
    bb += popc32(ui & ~ai);
  }
  ENG_UNROLL
  for (int i = 0; i < 2; ++i) {
    const bool in = wk + i < MASK_WORDS;
    u[i] = in ? pu[wk + i] : 0u;
    a[i] = pair && in ? pa[wk + i] : u[i];
  }
}
ENG_HD WinRaw win_raw(const Tables& t, int j) {
  WinRaw w;
  const int k = j - (t.nr - t.npair);
  const bool pair = k >= 0 && j < t.nr;
  w.j = j;
  w.y = t.path_y[j];
  w.n = t.path_n[j];
  w.w0 = t.path_w0[j];
  w.w1 = t.path_w1[j];
  w.u[0] = t.path_win[2 * j];
  w.u[1] = t.path_win[2 * j + 1];
  w.a[0] = pair ? t.pair_win[2 * k] : w.u[0];
  w.a[1] = pair ? t.pair_win[2 * k + 1] : w.u[1];
  w.na = pair ? t.pair_nab[k] : w.n;
  w.c = j < t.nr ? t.row_mu[j] : t.lim_sign[j - t.nr];
  w.m = 0;
  w.step = 1;
  w.c2 = 0.f;
  return w;
}
ENG_HD WinRaw limit_win_raw(const Tables& t, int k) {
  const int m = t.lim_first[k];
  WinRaw w = win_raw(t, t.nr + m);
  w.m = m;
  w.step = limit_step_rows(t, k);
  w.c2 = t.lim_sign[m + w.step - 1];
  return w;
}

// Lane l's entries of row w over a window of words (u, a, and the dofs
// before them, ba, bb: win_words): slot i holds the lane's dof of the
// window's chunk i, 0 off the support, its position its rank in body a's
// path or |a| plus its rank in the rest (PathRow); a lane off the support
// reads the row's first entries, which every row has: no branch.
template <int G, int W, bool THREE>
ENG_HD void win_load(const Scr& s, const WinRaw& w, const uint32_t* u, const uint32_t* a, int ba,
                     int bb, int l, RowRegs<W>& o) {
  ENG_UNROLL
  for (int i = 0; i < W; ++i) {
    const int b = l + i * G;  // the dof's bit in the window
    const int sh = b & 31;
    const uint32_t below = (1u << sh) - 1u;
    const uint32_t m0 = b < 32 ? below : ~0u, m1 = b < 32 ? 0u : below;
    const uint32_t uw = b < 32 ? u[0] : u[1], aw = b < 32 ? a[0] : a[1];
    const bool on = ((uw >> sh) & 1u) != 0, in_a = ((aw >> sh) & 1u) != 0;
    const int rank_a = popc32(a[0] & m0) + popc32(a[1] & m1);
    const int rank_b = popc32(u[0] & ~a[0] & m0) + popc32(u[1] & ~a[1] & m1);
    const int pos = in_a ? ba + rank_a : w.na + bb + rank_b;
    const float* y = s.Y + w.y + (on ? pos : 0);
    const float n = y[0];
    o.n[i] = on ? n : 0.f;
    if (THREE) {
      const float t1 = y[w.n], t2 = y[2 * w.n];
      o.t1[i] = on ? t1 : 0.f;
      o.t2[i] = on ? t2 : 0.f;
    } else {
      o.t1[i] = o.t2[i] = 0.f;
    }
  }
}

// Slot i of a window's entries (i uniform), selected without an index
template <int W>
ENG_HD void win_slot(const RowRegs<W>& r, int i, float& n, float& t1, float& t2) {
  n = r.n[0];
  t1 = r.t1[0];
  t2 = r.t2[0];
  ENG_UNROLL
  for (int q = 1; q < W; ++q) {
    n = i == q ? r.n[q] : n;
    t1 = i == q ? r.t1[q] : t1;
    t2 = i == q ? r.t2[q] : t2;
  }
}

// A lane's partials over a window from chunk c0: a contact row's four dots
// (FOUR), or a limit row's one, acc[0]
template <int K, int W, bool FOUR>
ENG_HD void win_dots(const RowRegs<W>& r, int c0, const LaneVec<K>& z, const LaneVec<K>& zp,
                     float* acc) {
  ENG_UNROLL
  for (int k = 0; k < K; ++k) {
    const int i = k - c0;
    if (i < 0 || i >= W) continue;
    float n, t1, t2;
    win_slot<W>(r, i, n, t1, t2);
    acc[0] = acc[0] + n * z.x[k];
    if (FOUR) {
      acc[1] = acc[1] + n * zp.x[k];
      acc[2] = acc[2] + t1 * z.x[k];
      acc[3] = acc[3] + t2 * z.x[k];
    }
  }
}

// A lane's update over a window: a contact row's three of z and one of zp
// (FOUR), or a limit step's z += w an
template <int K, int W, bool FOUR>
ENG_HD void win_update(const RowRegs<W>& r, int c0, LaneVec<K>& z, LaneVec<K>& zp, float ap,
                       float an, float a1, float a2) {
  ENG_UNROLL
  for (int k = 0; k < K; ++k) {
    const int i = k - c0;
    if (i < 0 || i >= W) continue;
    float n, t1, t2;
    win_slot<W>(r, i, n, t1, t2);
    if (FOUR) {
      zp.x[k] = zp.x[k] + n * ap;
      z.x[k] = ((z.x[k] + n * an) + t1 * a1) + t2 * a2;
    } else {
      z.x[k] = z.x[k] + n * an;
    }
  }
}

// One row's step of a sweep by windows: a contact row (FOUR: its four dots,
// contact_chain) or a limit step (its dot, limit_chain); `row` its first
// window's entries, `r` its PGS scalars
template <int G, int K, bool FOUR>
ENG_HD void win_step(const Tables& t, const Group<G>& g, const Scr& s, const WinRaw& w,
                     PerLane<RowRegs<win_chunks<G, K>()>, G>& row, const float* r,
                     PerLane<LaneVec<K>, G>& z, PerLane<LaneVec<K>, G>& zp) {
  constexpr int W = win_chunks<G, K>();
  const int c0 = 32 * w.w0 / G;
  PerLane<float, G> part[4];
  EACH_LANE(g, l) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    win_dots<K, W, FOUR>(row[l], c0, z[l], zp[l], acc);
    for (int wk = w.w0 + 2; wk <= w.w1; wk += 2) {  // a wide row's further windows
      uint32_t u[2], a[2];
      int ba, bb;
      win_words(t, w.j, wk, u, a, ba, bb);
      RowRegs<W> o;
      win_load<G, W, FOUR>(s, w, u, a, ba, bb, l, o);
      win_dots<K, W, FOUR>(o, 32 * wk / G, z[l], zp[l], acc);
    }
    ENG_UNROLL
    for (int i = 0; i < (FOUR ? 4 : 1); ++i) part[i][l] = acc[i];
  }
  ContactStep u = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float* const c = FOUR ? s.crow + CROW * w.j : s.lrow + LROW * w.m;
  if (FOUR) {
    float d[4];
    group_sum4(g, part, d);
    u = contact_chain(r, w.c, d);
  } else {
    u.an = limit_chain(r, c, w.c, w.step, w.c2, group_sum(g, part[0]));
  }
  EACH_LANE(g, l) {
    win_update<K, W, FOUR>(row[l], c0, z[l], zp[l], u.ap, u.an, u.a1, u.a2);
    for (int wk = w.w0 + 2; wk <= w.w1; wk += 2) {
      uint32_t uw[2], aw[2];
      int ba, bb;
      win_words(t, w.j, wk, uw, aw, ba, bb);
      RowRegs<W> o;
      win_load<G, W, FOUR>(s, w, uw, aw, ba, bb, l, o);
      win_update<K, W, FOUR>(o, 32 * wk / G, z[l], zp[l], u.ap, u.an, u.a1, u.a2);
    }
  }
  if (FOUR) contact_store(c, u);
}

// The contact rows (FOUR), or the limit steps, of a sweep: each row's words
// read two rows ahead, its first window's entries a row ahead, its scalars
// (its CRow block, or a limit step's LRow blocks) at its step's start.
template <int G, int K, bool FOUR>
ENG_HD void sweep_win(const Tables& t, const Group<G>& g, const Scr& s,
                      PerLane<LaneVec<K>, G>& z, PerLane<LaneVec<K>, G>& zp) {
  constexpr int W = win_chunks<G, K>();
  constexpr int R = FOUR ? CROW : 2 * LROW;
  const int n = FOUR ? t.nr : t.lim_steps;
  if (n == 0) return;
  PerLane<RowRegs<W>, G> row, next;
  WinRaw cur = FOUR ? win_raw(t, 0) : limit_win_raw(t, 0);
  EACH_LANE(g, l) win_load<G, W, FOUR>(s, cur, cur.u, cur.a, 0, 0, l, row[l]);
  WinRaw w = FOUR ? win_raw(t, n > 1 ? 1 : 0) : limit_win_raw(t, n > 1 ? 1 : 0);
  for (int j = 0; j < n; ++j) {
    EACH_LANE(g, l) win_load<G, W, FOUR>(s, w, w.u, w.a, 0, 0, l, next[l]);
    const int j2 = j + 2 < n ? j + 2 : n - 1;
    const WinRaw after = FOUR ? win_raw(t, j2) : limit_win_raw(t, j2);
    const float* const c = FOUR ? s.crow + CROW * cur.j : s.lrow + LROW * cur.m;
    float r[R];
    ENG_UNROLL
    for (int i = 0; i < R; ++i) r[i] = FOUR || i < LROW || cur.step == 2 ? c[i] : 0.f;
    win_step<G, K, FOUR>(t, g, s, cur, row, r, z, zp);
    row = next;
    cur = w;
    w = after;
  }
}

// The PGS sweeps of the global classes: the contact rows in order (floor
// rows, then pair rows), then the limit steps, as pgs_sweeps
template <int G, int K>
ENG_HD void pgs_sweeps_win(const Tables& t, const Group<G>& g, const Scr& s) {
  const int nv = t.nv;
  PerLane<LaneVec<K>, G> z, zp;
  EACH_LANE(g, l) {
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      const int d = l + k * G;
      z[l].x[k] = d < nv ? s.z[d] : 0.f;
      zp[l].x[k] = 0.f;
    }
  }
  for (int it = 0; it < t.iterations; ++it) {
    sweep_win<G, K, true>(t, g, s, z, zp);
    sweep_win<G, K, false>(t, g, s, z, zp);
  }
  EACH_LANE(g, l) {
    ENG_UNROLL
    for (int k = 0; k < K; ++k) {
      const int d = l + k * G;
      if (d < nv) {
        s.z[d] = z[l].x[k];
        s.zp[d] = zp[l].x[k];
      }
    }
  }
}
#endif

// The PGS sweeps of the class, z and zp in K chunks a lane
template <int G, int K>
ENG_HD void sweeps(const Tables& t, const Group<G>& g, const Scr& s) {
#ifdef ENG_GLOBAL_TABLES
  pgs_sweeps_win<G, K>(t, g, s);
#else
  pgs_sweeps<G, K>(t, g, s);
#endif
}

// Contact row r's J^T (contacts.py · scalar_jacobians) into its rows of Y,
// by position over its support (PathRow): body a's path's dofs in order,
// then b's own; a dof's weight +1 on body a's root path only, -1 on body
// b's only (pair rows), 0 on both. One lane a row.
ENG_HD void jacobian_row(const Tables& t, const Scr& s, int r) {
  const int nfloor = t.nr - t.npair;
  const PathRow p = row_path(t, r);
  DofSet plus = p.u, minus = dofs_none();
  V3 dirs[3];
  if (r < nfloor) {
    dirs[0] = v3_load(t.row_n + 3 * r);
    dirs[1] = v3_load(t.row_t1 + 3 * r);
    dirs[2] = v3_load(t.row_t2 + 3 * r);
  } else {
    const int k = r - nfloor;
    const DofSet mb = anc_path(t, t.pair_b[k]);
    plus = dofs_and_not(p.a, mb);
    minus = p.bo;
    for (int j = 0; j < 3; ++j) dirs[j] = s.dirs[3 * k + j];
  }
  const V3 Pr = s.P[r];
  float* const yr = s.Y + p.y;
  DofSet w = p.a;
  for (int j = 0; j < p.n; ++j) {
    const int d = dofs_any(w) ? dofs_pop_low(w) : (w = p.bo, dofs_pop_low(w));
    if (on_path(plus, d) || on_path(minus, d)) {
      const SV& S = s.fk.S[dof_model(s, d)];
      const V3 vel = v3_add(S.lin, v3_cross(S.ang, Pr));
      for (int k = 0; k < 3; ++k) {
        const float jd = v3_dot(mm_operand(dirs[k]), mm_operand(vel));
        yr[k * p.n + j] = on_path(minus, d) ? -jd : jd;
      }
    } else {
      for (int k = 0; k < 3; ++k) yr[k * p.n + j] = 0.f;
    }
  }
}

// ---- one physics substep: step.py · make_substep_scalar --------------------

// Advances the scratch's q, v in place and writes the contact depths of this
// substep. Every lane of the group calls it; it ends synchronised.
template <int G>
ENG_HD void substep(const Tables& t, const Group<G>& g, const Scr& s) {
  const int nv = t.nv, nr = t.nr, nl = t.nl;
  const int nfloor = nr - t.npair;
  const FK& fk = s.fk;
  // the dynamics right-hand side, then L^-T of it
  float* const ydyn = s.Y;

  // FK, RNE and the composite inertias recurse over the bodies: one lane
  if (g.leader()) {
    forward_kinematics(t, s.q, s.v, fk, s.inert);
    bias_forces(t, fk, s.inert, s.avp, s.f, s.z);  // by the model's dofs
    composite_inertias(t, s.inert);
  }
  g.sync();
  if (t.stop_after == 1) return;
  EACH_LANE(g, l) {
    for (int d = l; d < nv; d += G) {
      // passive forces (dynamics.py · passive_forces); pack_tables zeroes
      // the stiffness of free dofs, so dof_qadr is read for hinge/slide only
      float tp = 0.f;
      if (t.neg_damping[d] != 0.f) tp = tp + t.neg_damping[d] * s.v[d];
      if (t.neg_stiffness[d] != 0.f)
        tp = tp + t.neg_stiffness[d] * (s.q[t.dof_qadr[d]] - t.springref[d]);
      ydyn[t.dof_perm[d]] = (s.tau[d] + tp) - s.z[d];  // by the factor's dofs
      mass_matrix_row(t, s, d);
    }
    // narrowphase (contacts.py · narrowphase_scalar): point and disk
    // candidates vs planes, then the pair rows, whose directions are per env
    for (int r = l; r < nfloor; r += G) {
      const int b = t.row_body[r];
      const V3 n = v3_load(t.row_n + 3 * r);
      V3 x = v3_add(fk.p[b], m3_vec(fk.R[b], v3_load(t.row_local + 3 * r)));
      if (t.row_disk[r]) x = v3_add(x, disk_rim(t, fk.R[b], n, r));
      s.depth[r] = t.row_depth0[r] - v3_dot(n, x);
      s.P[r] = v3_sub(x, v3_load(t.row_nrad + 3 * r));
    }
    for (int k = l; k < t.npair; k += G)
      pair_contact(t, fk, k, s.depth[nfloor + k], s.P[nfloor + k], s.dirs + 3 * k);
  }
  g.sync();
  if (t.stop_after == 2) return;
  ltl_factor(t, g, s);  // and ydyn to L^-T ydyn
  if (t.stop_after == 3) return;

  const bool rows = nr > 0 || nl > 0;
  if (rows) {
    // constraint rows J^T (contacts.py · scalar_jacobians, step.py) into
    // Y's rows after the dynamics', lanes over rows, each over its support
    // (jacobian_row): 3 directions per contact row
    EACH_LANE(g, l) {
      for (int r = l; r < nr; r += G) jacobian_row(t, s, r);
    }
    // a limit row over its dof's chain (its dof last), lanes over limit
    // steps (a pair's one row)
    EACH_LANE(g, l) {
      for (int k = l; k < t.lim_steps; k += G) {
        const PathRow p = row_path(t, nr + t.lim_first[k]);
        float* const w = s.Y + p.y;
        for (int j = 0; j < p.n; ++j) w[j] = j == p.n - 1 ? 1.f : 0.f;
      }
    }
    g.sync();
  }
  // the forward solves, one lane a right-hand side: y = L^-T J^T over each
  // row's support (L^-T rhs came with the factorization)
  if (rows) {
    EACH_LANE(g, l) {
      for (int j = l; j < 3 * nr + t.lim_steps; j += G) {
        // a contact row's direction, or a limit step's row
        const int r = j < 3 * nr ? j / 3 : nr + t.lim_first[j - 3 * nr];
        const PathRow p = row_path(t, r);
        float* const y = s.Y + p.y + (j < 3 * nr ? (j - 3 * r) * p.n : 0);
        if (r < nfloor || r >= nr)
          path_solve<G, false>(s, p, y);
        else
          path_solve<G, true>(s, p, y);
      }
    }
    g.sync();
  }

  if (rows) {
    // z = L v + dt L^-T rhs: the PGS runs in Cholesky square-root space
    EACH_LANE(g, l) {
      for (int i = l; i < nv; i += G) {
        const DofPath pi = dof_path(s, i);
        const float* const Li = s.L + pi.row;
        DofSet anc = pi.anc;
        float a = 0.f;
        for (int m = 0; dofs_any(anc); ++m) a = a + Li[m] * s.v[dof_model(s, dofs_pop_low(anc))];
        a = a + Li[pi.depth] * s.v[pi.model];
        s.z[i] = a + t.dt * ydyn[i];
      }
    }
    g.sync();
    // PGS set-up (contacts.py · solve_scalar), lanes over rows, into each
    // row's CRow or LRow block; pair rows as point rows
    EACH_LANE(g, l) {
      for (int r = l; r < nr; r += G) {
        const PathRow p = row_path(t, r);
        const float* yn = s.Y + p.y;
        float* const c = s.crow + CROW * r;
        for (int k = 0; k < 3; ++k) {
          const float* yk = yn + k * p.n;
          c[CR_DINV + k] = 1.f / (dotn(p.n, yk, yk) + t.reg);
        }
        // the Gram entries of the sweep's tangent dots (contact_step)
        c[CR_GRAM] = dotn(p.n, yn, yn + p.n);
        c[CR_GRAM + 1] = dotn(p.n, yn, yn + 2 * p.n);
        c[CR_GRAM + 2] = dotn(p.n, yn + p.n, yn + 2 * p.n);
        const float dep = s.depth[r];
        if (t.e_comb_zero) {
          c[CR_B_VEL] = dep > 0.f ? 0.f : dep / t.dt;
        } else {
          // over the support by position
          float vn_pre = 0.f;
          DofSet w = p.a;
          for (int j = 0; j < p.n; ++j) {
            const int d = dofs_any(w) ? dofs_pop_low(w) : (w = p.bo, dofs_pop_low(w));
            vn_pre = vn_pre + mm_operand(yn[j]) * mm_operand(s.z[d]);
          }
          float bounce = vn_pre < t.neg_rest_threshold ? t.neg_e_comb * vn_pre : 0.f;
          bool touching = dep >= vn_pre * t.dt;
          c[CR_B_VEL] = dep > 0.f ? bounce : ((bounce > 0.f && touching) ? bounce : dep / t.dt);
        }
        c[CR_B_POS] = t.erp_over_dt * (dep - t.slop);
        c[CR_LAM_N] = c[CR_LAM_T1] = c[CR_LAM_T2] = c[CR_LAM_P] = 0.f;
      }
      // a limit step's inverse diagonal by its first row, and a pair's |w|^2
      // in its second row's
      for (int k = l; k < t.lim_steps; k += G) {
        const int m = t.lim_first[k];
        const PathRow p = row_path(t, nr + m);
        const float* w = s.Y + p.y;
        const float w2 = dotn(p.n, w, w);
        s.lrow[LROW * m + LR_D] = 1.f / (w2 + t.reg);
        if (limit_step_rows(t, k) == 2) s.lrow[LROW * (m + 1) + LR_D] = w2;
      }
      for (int m = l; m < nl; m += G) {
        float viol = t.lim_sign[m] * (t.lim_bound[m] - s.q[t.lim_qadr[m]]);
        s.lrow[LROW * m + LR_B] = t.limit_erp_over_dt * viol;
        s.lrow[LROW * m + LR_LAM] = 0.f;
      }
    }
    g.sync();

    // the sweeps in one chunk a lane where the group has a lane for every
    // dof, so that only a model with more dofs than lanes (9-12 at G=8,
    // Atlas at G=32) carries the later chunks' registers and predicated steps
    if (lane_chunks<G>() > 1 && nv > G)
      sweeps<G, lane_chunks<G>()>(t, g, s);
    else
      sweeps<G, 1>(t, g, s);
    g.sync();
    // v = L^-1 z and vp = L^-1 zp, one lane each
    EACH_LANE(g, l) {
      if (l == 0) ltl_solve(t, s, s.z, s.v3o);
      if (l == (G > 1 ? 1 : 0)) ltl_solve(t, s, s.zp, s.vp);
    }
  } else if (g.leader()) {
    ltl_solve(t, s, ydyn, s.v3o);  // qdd
    for (int d = 0; d < nv; ++d) {
      s.v3o[d] = s.v[d] + t.dt * s.v3o[d];
      s.vp[d] = 0.f;
    }
  }
  g.sync();
  // velocity clamp, then semi-implicit Euler with the split-impulse velocity
  EACH_LANE(g, l) {
    for (int d = l; d < nv; d += G) {
      s.v3o[d] = jclip(s.v3o[d], -t.max_velocity, t.max_velocity);
      s.v[d] = s.v3o[d];
    }
  }
  g.sync();
  // (dynamics.py · integrate), lanes over bodies: a free joint moves by
  // R v_lin and turns by the exponential map of R v_ang, both read from the
  // old quaternion
  EACH_LANE(g, l) {
    for (int i = l; i < t.nb; i += G) {
      const int qa = t.q_adr[i], va = t.v_adr[i];
      float* q = s.q;
      const float *v3o = s.v3o, *vp = s.vp;
      if (t.jtype[i] == JT_FREE) {
        float w[6];
        for (int k = 0; k < 6; ++k) w[k] = v3o[va + k] + vp[va + k];
        const M3 R = m3_from_quat(q + qa + 3);
        const V3 omega = m3_vec(R, v3(w[0], w[1], w[2]));
        const V3 lin = m3_vec(R, v3(w[3], w[4], w[5]));
        q[qa] = q[qa] + t.dt * lin.x;
        q[qa + 1] = q[qa + 1] + t.dt * lin.y;
        q[qa + 2] = q[qa + 2] + t.dt * lin.z;
        quat_integrate(q + qa + 3, omega, t.dt);
      } else {
        q[qa] = q[qa] + t.dt * (v3o[va] + vp[va]);
      }
    }
  }
  g.sync();
}

// ---- walker task: locomotion.py · WalkerTask and the Flagrun tasks ---------

ENG_HD void mean_parts_xy(const Tables& t, const FK& fk, float& bx, float& by) {
  float sx = 0.f, sy = 0.f;
  for (int k = 0; k < t.nparts; ++k) {
    const int h = t.part_host[k];
    V3 p = v3_add(fk.p[h], m3_vec(fk.R[h], v3_load(t.part_pos + 3 * k)));
    sx = sx + p.x;
    sy = sy + p.y;
  }
  bx = sx / (float)t.nparts;
  by = sy / (float)t.nparts;
}

// HumanoidFlagrunTask._draw_flag: flag number `count` of this episode.
ENG_HD void draw_flag(const Tables& t, uint32_t seed, uint32_t env_id, uint32_t epoch,
                      float count, float& tx, float& ty) {
  const uint32_t e2 = hash_epoch(epoch, count);
  tx = uniform(seed, (uint32_t)t.flag_streams[0], env_id, e2, t.flag_lo_x, t.flag_span_x);
  ty = uniform(seed, (uint32_t)t.flag_streams[1], env_id, e2, t.flag_lo_y, t.flag_span_y);
}

ENG_HD V3 frame_point(const Tables& t, const FK& fk, int k) {
  const int h = t.part_host[k];
  return v3_add(fk.p[h], m3_vec(fk.R[h], v3_load(t.part_pos + 3 * k)));
}

// Pusher's object or Striker's goal: (ux, uy) on two streams, moved
// radially from the centre c to at least 0.18 from it, less the slides'
// base, into two q entries. Every product and sum rounds once, as the plain
// version's tensor ops do (the reset is compared bitwise).
ENG_HD void push_out_draw(const Tables& t, uint32_t seed, uint32_t env_id, uint32_t epoch,
                          float* q) {
  const float ux = uniform(seed, (uint32_t)t.push_stream[0], env_id, epoch, t.push_lo[0],
                           t.push_span[0]);
  const float uy = uniform(seed, (uint32_t)t.push_stream[1], env_id, epoch, t.push_lo[1],
                           t.push_span[1]);
  const float dx = add_rn(ux, -t.push_centre[0]), dy = add_rn(uy, -t.push_centre[1]);
  const float d = add_rn(sqrtf(add_rn(mul_rn(dx, dx), mul_rn(dy, dy))), 1e-9f);
  const float scale = jmax((float)0.18 / d, 1.f);
  q[t.push_qadr[0]] = add_rn(add_rn(t.push_centre[0], mul_rn(dx, scale)), -t.push_base[0]);
  q[t.push_qadr[1]] = add_rn(add_rn(t.push_centre[1], mul_rn(dy, scale)), -t.push_base[1]);
}

// The walker family's aux of a fresh episode (potential against the walk
// target or the first flag; FlagrunHarder's lying pose after it).
ENG_HD void walker_initial_aux(const Tables& t, const FK& fk, uint32_t seed, uint32_t env_id,
                               uint32_t epoch, float* q, const float* v, float* aux) {
  float tx = t.target_x, ty = t.target_y;
  if (t.task_kind != TASK_WALKER) {  // the first flag; the potential is against it
    draw_flag(t, seed, env_id, epoch, 0.f, tx, ty);
    aux[t.ax_flag_timeout] = t.flag_timeout;
    aux[t.ax_flag_count] = 0.f;
  }
  forward_kinematics(t, q, v, fk, nullptr);
  float bx, by;
  mean_parts_xy(t, fk, bx, by);
  float dx = tx - bx, dy = ty - by;
  float dist = sqrtf(dx * dx + dy * dy);
  aux[t.ax_initial_z] = t.initial_z;
  aux[t.ax_potential] = -dist / t.control_dt;
  aux[t.ax_target_x] = tx;
  aux[t.ax_target_y] = ty;
  if (t.task_kind == TASK_FLAGRUN_HARDER) {
    aux[t.ax_ground_counter] = 0.f;
    aux[t.ax_frame] = 0.f;
    // half the episodes start lying down, the root pitched +-90 degrees
    // about y (after the potential, as the plain version does)
    const bool lying = uniform(seed, (uint32_t)t.lie_streams[0], env_id, epoch, 0.f, 1.f) < 0.5f;
    const float sign =
        uniform(seed, (uint32_t)t.lie_streams[1], env_id, epoch, 0.f, 1.f) < 0.5f ? 1.f : -1.f;
    if (lying) {
      const int root = t.root_qadr;
      q[root + 2] = t.lie_z;
      q[root + 3] = t.lie_c;
      q[root + 5] = mul_rn(sign, t.lie_c);
    }
  }
}

// Reacher's potential, -100 |fingertip - target|, and the difference.
ENG_HD float reacher_potential(const Tables& t, const FK& fk, V3& d) {
  d = v3_sub(frame_point(t, fk, 0), frame_point(t, fk, 1));
  return (float)-100.0 * sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
}

// Fresh episode: initial_state_scalar of the task. aux in sorted key order;
// fk is scratch for the potential. One lane.
ENG_HD void initial_state(const Tables& t, const FK& fk, uint32_t seed, uint32_t env_id,
                          uint32_t epoch, float* q, float* v, float* aux) {
  for (int j = 0; j < t.nq; ++j) q[j] = t.qpos0[j];
  for (int k = 0; k < t.nqdraw; ++k) {
    float u = uniform(seed, (uint32_t)t.qdraw_stream[k], env_id, epoch, t.qdraw_lo[k],
                      t.qdraw_span[k]);
    q[t.qdraw_adr[k]] = add_rn(t.qdraw_base[k], u);
  }
  if (t.task_kind == TASK_PUSHER || t.task_kind == TASK_STRIKER)
    push_out_draw(t, seed, env_id, epoch, q);
  if (t.task_kind == TASK_MJ_REACHER) {  // the target, uniform in a disk
    const float u = uniform(seed, (uint32_t)t.disk_streams[0], env_id, epoch, 0.f, 1.f);
    const float ang = uniform(seed, (uint32_t)t.disk_streams[1], env_id, epoch, t.disk_ang_lo,
                              t.disk_ang_span);
    const float r = mul_rn(t.disk_r, sqrtf(u));
    q[t.jq[2]] = mul_rn(r, cosf(ang));
    q[t.jq[3]] = mul_rn(r, sinf(ang));
  }
  for (int d = 0; d < t.nv; ++d) v[d] = 0.f;
  for (int k = 0; k < t.nvdraw; ++k)
    v[t.vdraw_dof[k]] = uniform(seed, (uint32_t)t.vdraw_stream[k], env_id, epoch, t.vdraw_lo,
                                t.vdraw_span);
  if (t.task_kind <= TASK_FLAGRUN_HARDER) {
    walker_initial_aux(t, fk, seed, env_id, epoch, q, v, aux);
  } else if (t.task_kind == TASK_REACHER) {
    forward_kinematics(t, q, v, fk, nullptr);
    V3 d;
    aux[t.ax_potential] = reacher_potential(t, fk, d);
  } else if (t.task_kind == TASK_STRIKER) {
    aux[t.ax_min_dist] = 1e3f;
    aux[t.ax_striked] = aux[t.ax_strike_x] = aux[t.ax_strike_y] = aux[t.ax_strike_z] = 0.f;
  } else if (t.task_kind == TASK_THROWER) {
    aux[t.ax_hit] = aux[t.ax_hit_x] = aux[t.ax_hit_y] = 0.f;
  } else if (t.task_kind == TASK_MJ_WALKER) {
    aux[t.ax_x] = q[0];
  }
}

// HumanoidFlagrunHarderTask.pre_physics_scalar: every cube_period frames
// past cube_min_frame, while the robot stands (ground_counter 0), the cube
// is put 4 m from the torso's led position and hurled at it. The root's
// q/v entries are 0..6 / 3..5, as in the plain version (pack_tables checks
// that the root is the first body).
ENG_HD void cube_throw(const Tables& t, uint32_t seed, uint32_t env_id, uint32_t epoch,
                       float* q, float* v, const float* aux) {
  const float frame = aux[t.ax_frame];
  const bool hit = fmodf(frame, t.cube_period) == 0.f && frame > t.cube_min_frame &&
                   aux[t.ax_ground_counter] == 0.f;
  if (!hit) return;
  const uint32_t e2 = hash_epoch(epoch, frame);
  const int* cs = t.cube_streams;
  const float angle = uniform(seed, (uint32_t)cs[0], env_id, e2, t.angle_lo, t.angle_span);
  const float speed = uniform(seed, (uint32_t)cs[1], env_id, e2, t.speed_lo, t.speed_span);
  const float fd = t.cube_from_dist;
  // smath.quat_rotate(root quaternion, body-frame linear velocity)
  const float w = q[3], x = q[4], y = q[5], z = q[6];
  const float v0 = v[3], v1 = v[4], v2 = v[5];
  const float tx = 2.f * (y * v2 - z * v1);
  const float ty = 2.f * (z * v0 - x * v2);
  const float tz = 2.f * (x * v1 - y * v0);
  const float vw0 = v0 + w * tx + (y * tz - z * ty);
  const float vw1 = v1 + w * ty + (z * tx - x * tz);
  const float vw2 = v2 + w * tz + (x * ty - y * tx);
  const float lead = fd / speed;
  const float g0 = q[0] + vw0 * lead, g1 = q[1] + vw1 * lead, g2 = q[2] + vw2 * lead;
  const float px = g0 + fd * cosf(angle), py = g1 + fd * sinf(angle), pz = g2 + 1.f;
  const float d0 = g0 - px, d1 = g1 - py, d2 = g2 - pz;
  const float dn = sqrtf(d0 * d0 + d1 * d1 + d2 * d2) + 1e-9f;
  const float jx = uniform(seed, (uint32_t)cs[2], env_id, e2, t.jitter_lo, t.jitter_span);
  const float jy = uniform(seed, (uint32_t)cs[3], env_id, e2, t.jitter_lo, t.jitter_span);
  const float jz = uniform(seed, (uint32_t)cs[4], env_id, e2, t.jitter_lo, t.jitter_span);
  const int qa = t.cube_qadr, va = t.cube_vadr;
  q[qa] = px;
  q[qa + 1] = py;
  q[qa + 2] = pz;
  q[qa + 3] = 1.f;
  q[qa + 4] = q[qa + 5] = q[qa + 6] = 0.f;
  v[va] = v[va + 1] = v[va + 2] = 0.f;
  v[va + 3] = speed * d0 / dn + jx;
  v[va + 4] = speed * d1 / dn + jy;
  v[va + 5] = speed * d2 / dn + jz;
}

// An actuated joint's position relative to its range, and its scaled speed
ENG_HD float joint_rel(const Tables& t, const float* q, int k) {
  return (q[t.act_qadr[k]] - t.j_mid[k]) / t.j_half[k];
}
ENG_HD float joint_speed(const Tables& t, const float* v, int k) {
  return (float)0.1 * v[t.act_dof[k]];
}

// obs, reward, termination, new aux and reward components: output_scalar,
// with the Flagrun retarget and the FlagrunHarder get-up machine. One lane;
// fk is scratch.
ENG_HD void walker_output(const Tables& t, const FK& fk, uint32_t seed, uint32_t env_id,
                          uint32_t epoch, const float* q, const float* v, const float* depth,
                          const float* a, const float* aux, float* obs, float& reward,
                          bool& term, float* aux2, float* comps) {
  forward_kinematics(t, q, v, fk, nullptr);
  const int na = t.act;
  float joints_at_limit = 0.f;
  for (int k = 0; k < na; ++k)
    joints_at_limit = joints_at_limit + (fabsf(joint_rel(t, q, k)) > (float)0.99 ? 1.f : 0.f);

  const int bb = t.base_body;
  const M3 Rb = fk.R[bb];
  V3 com = fk.com[bb];
  float roll = s_atan2(Rb.m[7], Rb.m[8]);
  float pitch = s_atan2(-Rb.m[6], sqrtf(Rb.m[7] * Rb.m[7] + Rb.m[8] * Rb.m[8]));
  float yaw = s_atan2(Rb.m[3], Rb.m[0]);
  V3 vel = v3_add(fk.vel[bb].lin, v3_cross(fk.vel[bb].ang, com));

  float bx, by;
  mean_parts_xy(t, fk, bx, by);
  float bz = com.z;
  for (int k = 0; k < t.naux; ++k) aux2[k] = aux[k];
  float tx = aux[t.ax_target_x], ty = aux[t.ax_target_y];
  float dx = tx - bx, dy = ty - by;
  if (t.task_kind != TASK_WALKER) {
    // HumanoidFlagrunTask._retarget: a new flag when this one is reached
    // (dist < 1) or its timer runs out
    const float dist0 = sqrtf(dx * dx + dy * dy);
    const float timeout = aux[t.ax_flag_timeout] - 1.f;
    const bool need = (dist0 < 1.f) || (timeout <= 0.f);
    const float count = aux[t.ax_flag_count];
    if (need) draw_flag(t, seed, env_id, epoch, count + 1.f, tx, ty);
    aux2[t.ax_flag_timeout] = need ? t.flag_timeout : timeout;
    aux2[t.ax_flag_count] = need ? count + 1.f : count;
    dx = tx - bx;
    dy = ty - by;
  }
  float angle_to_target = s_atan2(dy, dx) - yaw;
  float dist = sqrtf(dx * dx + dy * dy);
  float cy = cosf(-yaw), sy = sinf(-yaw);
  float vx = cy * vel.x - sy * vel.y;
  float vy = sy * vel.x + cy * vel.y;
  float vz = vel.z;

  float feet[MAX_FEET];
  for (int f = 0; f < t.nfeet; ++f) feet[f] = 0.f;
  for (int r = 0; r < t.nr; ++r) {
    const int f = t.row_foot[r];
    if (f >= 0 && depth[r] > 0.f) feet[f] = 1.f;
  }

  int o = 0;
  obs[o++] = bz - aux[t.ax_initial_z];
  obs[o++] = sinf(angle_to_target);
  obs[o++] = cosf(angle_to_target);
  obs[o++] = (float)0.3 * vx;
  obs[o++] = (float)0.3 * vy;
  obs[o++] = (float)0.3 * vz;
  obs[o++] = roll;
  obs[o++] = pitch;
  for (int k = 0; k < na; ++k) {
    obs[o++] = joint_rel(t, q, k);
    obs[o++] = joint_speed(t, v, k);
  }
  for (int f = 0; f < t.nfeet; ++f) obs[o++] = feet[f];
  for (int k = 0; k < o; ++k) obs[k] = jclip(obs[k], -5.f, 5.f);

  // alive bonus (WalkerTask._alive, or FlagrunHarder's _alive_aux)
  float alive;
  if (t.task_kind == TASK_FLAGRUN_HARDER) {
    // get-up machine: count consecutive low frames, decay when up
    const float c0 = aux[t.ax_ground_counter];
    const float counter = bz < 0.8f ? c0 + 1.f : jmax(c0 - 1.f, 0.f);
    const float leak = 2.f * jclip(bz, 0.f, 0.8f) / 0.8f;
    alive = counter < t.ground_limit ? leak : -1.f;
    aux2[t.ax_ground_counter] = counter;
    aux2[t.ax_frame] = aux[t.ax_frame] + 1.f;
  } else {
    bool ok;
    if (t.alive_mode == ALIVE_HOPPER) {  // Hopper, Walker2D
      ok = bz > 0.8f && fabsf(pitch) < 1.f;
    } else if (t.alive_mode == ALIVE_ANT) {
      ok = bz > 0.26f;
    } else if (t.alive_mode == ALIVE_HUMANOID) {
      ok = bz > 0.78f;
    } else {  // "cheetah": dead if a shin or thigh (feet 1, 2, 4, 5) touches
      bool bad_touch = (feet[1] + feet[2] + feet[4] + feet[5]) > 0.5f;
      ok = (fabsf(pitch) < 1.f) && !bad_touch;
    }
    const float up = t.alive_mode == ALIVE_HUMANOID ? 2.f : 1.f;
    alive = ok ? up : -1.f;
  }

  float potential = -dist / t.control_dt;
  float progress = potential - aux[t.ax_potential];
  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < na; ++k) s1 = s1 + fabsf(a[k] * joint_speed(t, v, k));
  for (int k = 0; k < na; ++k) s2 = s2 + a[k] * a[k];
  float electricity = t.elec_coef * s1 / t.n_act + t.stall_coef * s2 / t.n_act;
  float limit_cost = t.limit_coef * joints_at_limit;
  float feet_collision = 0.f;
  reward = alive + progress + electricity + limit_cost + feet_collision;
  term = alive < 0.f;
  aux2[t.ax_potential] = potential;
  aux2[t.ax_target_x] = tx;
  aux2[t.ax_target_y] = ty;
  comps[t.cp_alive] = alive;
  comps[t.cp_electricity] = electricity;
  comps[t.cp_feet_collision] = feet_collision;
  comps[t.cp_joints_at_limit] = limit_cost;
  comps[t.cp_progress] = progress;
}

// ---- manipulation.py · ReacherTask.output_scalar ----------------------------
// act slots 0, 1: the central and elbow joints; jq 0, 1: the target's
// slides; frames 0, 1: fingertip and target. Never terminates.
ENG_HD void reacher_output(const Tables& t, const FK& fk, const float* q, const float* v,
                           const float* a, const float* aux, float* obs, float& reward,
                           bool& term, float* aux2, float* comps) {
  forward_kinematics(t, q, v, fk, nullptr);
  const float theta = q[t.act_qadr[0]];
  const float theta_dot = (float)0.1 * v[t.act_dof[0]];
  const float gamma_rel = (q[t.act_qadr[1]] - t.j_mid[1]) / t.j_half[1];
  const float gamma_dot = (float)0.1 * v[t.act_dof[1]];
  V3 d;
  const float potential = reacher_potential(t, fk, d);
  obs[0] = q[t.jq[0]];
  obs[1] = q[t.jq[1]];
  obs[2] = d.x;
  obs[3] = d.y;
  obs[4] = cosf(theta);
  obs[5] = sinf(theta);
  obs[6] = theta_dot;
  obs[7] = gamma_rel;
  obs[8] = gamma_dot;
  const float progress = potential - aux[t.ax_potential];
  const float electricity = (float)-0.1 * (fabsf(a[0] * theta_dot) + fabsf(a[1] * gamma_dot)) -
                            (float)0.01 * (fabsf(a[0]) + fabsf(a[1]));
  const float stuck = fabsf(fabsf(gamma_rel) - 1.f) < (float)0.01 ? (float)-0.1 : 0.f;
  reward = progress + electricity + stuck;
  term = false;
  aux2[t.ax_potential] = potential;
  comps[t.cp_electricity] = electricity;
  comps[t.cp_progress] = progress;
  comps[t.cp_stuck_joint] = stuck;
}

ENG_HD float norm_eps(V3 d) {  // sqrt(|d|^2 + 1e-12), the sum in Python's order
  return sqrtf(d.x * d.x + d.y * d.y + d.z * d.z + (float)1e-12);
}

// ---- manipulation.py · Pusher/Striker/ThrowerTask.output_scalar -------------
// obs(23) = [arm q, arm q', tips, object, goal] (frames 0-2); never
// terminates.
ENG_HD void arm_output(const Tables& t, const FK& fk, const float* q, const float* v,
                       const float* a, const float* aux, float* obs, float& reward, bool& term,
                       float* aux2, float* comps) {
  forward_kinematics(t, q, v, fk, nullptr);
  const V3 tips = frame_point(t, fk, 0), obj = frame_point(t, fk, 1), goal = frame_point(t, fk, 2);
  const int na = t.act;
  int o = 0;
  for (int k = 0; k < na; ++k) obs[o++] = q[t.act_qadr[k]];
  for (int k = 0; k < na; ++k) obs[o++] = v[t.act_dof[k]];
  const V3 pts[3] = {tips, obj, goal};
  for (int j = 0; j < 3; ++j) {
    obs[o++] = pts[j].x;
    obs[o++] = pts[j].y;
    obs[o++] = pts[j].z;
  }
  float ctrl = 0.f;
  for (int k = 0; k < na; ++k) ctrl = ctrl + a[k] * a[k];
  ctrl = -ctrl;
  for (int k = 0; k < t.naux; ++k) aux2[k] = aux[k];
  term = false;
  if (t.task_kind == TASK_PUSHER) {
    const float dist = -norm_eps(v3_sub(obj, goal));
    const float near = -norm_eps(v3_sub(tips, obj));
    reward = dist + 0.5f * near + (float)0.1 * ctrl;
    comps[t.cp_ctrl] = (float)0.1 * ctrl;
    comps[t.cp_dist] = dist;
    comps[t.cp_near] = 0.5f * near;
  } else if (t.task_kind == TASK_STRIKER) {
    // the episode's least ball-goal distance; the strike point, fixed when
    // the arm first comes within 0.1 of the ball
    const float d1 = norm_eps(v3_sub(obj, tips));
    const float d2 = norm_eps(v3_sub(obj, goal));
    const float min_dist = jmin(aux[t.ax_min_dist], d2);
    const bool newly = d1 < (float)0.1 && aux[t.ax_striked] < 0.5f;
    const float striked = jmax(aux[t.ax_striked], newly ? 1.f : 0.f);
    const float sx = newly ? tips.x : aux[t.ax_strike_x];
    const float sy = newly ? tips.y : aux[t.ax_strike_y];
    const float sz = newly ? tips.z : aux[t.ax_strike_z];
    const float d3 = norm_eps(v3(obj.x - sx, obj.y - sy, obj.z - sz));
    const float near = striked > 0.5f ? -d3 : -d1;
    const float dist = -min_dist;
    reward = 3.f * dist + (float)0.1 * ctrl + 0.5f * near;
    aux2[t.ax_min_dist] = min_dist;
    aux2[t.ax_striked] = striked;
    aux2[t.ax_strike_x] = sx;
    aux2[t.ax_strike_y] = sy;
    aux2[t.ax_strike_z] = sz;
    comps[t.cp_ctrl] = (float)0.1 * ctrl;
    comps[t.cp_dist] = 3.f * dist;
    comps[t.cp_near] = 0.5f * near;
  } else {  // TASK_THROWER: from where the ball first fell below -0.25
    const bool newly = obj.z < (float)-0.25 && aux[t.ax_hit] < 0.5f;
    const float hit = jmax(aux[t.ax_hit], newly ? 1.f : 0.f);
    const float hx = newly ? obj.x : aux[t.ax_hit_x];
    const float hy = newly ? obj.y : aux[t.ax_hit_y];
    const float gx = (hit > 0.5f ? hx : obj.x) - goal.x;
    const float gy = (hit > 0.5f ? hy : obj.y) - goal.y;
    const float dist = -sqrtf(gx * gx + gy * gy + (float)1e-12);
    reward = dist + (float)0.002 * ctrl;
    aux2[t.ax_hit] = hit;
    aux2[t.ax_hit_x] = hx;
    aux2[t.ax_hit_y] = hy;
    comps[t.cp_ctrl] = (float)0.002 * ctrl;
    comps[t.cp_dist] = dist;
  }
}

// ---- pendula.py · InvertedPendulumTask, InvertedDoublePendulumTask --------
// act slot 0: the slider; jq/jv 0 (and 1): the hinge(s); base_body: pole2.
ENG_HD void pendulum_output(const Tables& t, const FK& fk, const float* q, const float* v,
                            float* obs, float& reward, bool& term, float* comps) {
  const float theta = q[t.jq[0]], theta_dot = v[t.jv[0]];
  obs[0] = q[t.act_qadr[0]];
  obs[1] = v[t.act_dof[0]];
  if (t.task_kind == TASK_PENDULUM) {
    obs[2] = cosf(theta);
    obs[3] = sinf(theta);
    obs[4] = theta_dot;
    reward = t.swingup ? cosf(theta) : 1.f;
    term = !t.swingup && fabsf(theta) > (float)0.2;
    comps[t.cp_reward] = reward;
    return;
  }
  forward_kinematics(t, q, v, fk, nullptr);
  const V3 com2 = fk.com[t.base_body];
  const float pos_x = com2.x, pos_y = com2.z;  // the reference's y is height
  const float gamma = q[t.jq[1]], gamma_dot = v[t.jv[1]];
  obs[2] = pos_x;
  obs[3] = cosf(theta);
  obs[4] = sinf(theta);
  obs[5] = theta_dot;
  obs[6] = cosf(gamma);
  obs[7] = sinf(gamma);
  obs[8] = gamma_dot;
  const float h = pos_y + (float)0.3 - 2.f;
  const float dist_penalty = (float)0.01 * (pos_x * pos_x) + h * h;
  const float vel_penalty =
      (float)1e-3 * (theta_dot * theta_dot) + (float)5e-3 * (gamma_dot * gamma_dot);
  const float alive = 10.f;
  reward = alive - dist_penalty - vel_penalty;
  term = pos_y + (float)0.3 <= 1.f;
  comps[t.cp_alive] = alive;
  comps[t.cp_dist_penalty] = -dist_penalty;
  comps[t.cp_vel_penalty] = -vel_penalty;
}

// ---- mujoco_family.py · the Gym-MuJoCo mirrors --------------------------------

ENG_HD float sum_sq(int n, const float* a) {  // Python's sum(x * x for x in a)
  float s = 0.f;
  for (int k = 0; k < n; ++k) s = s + a[k] * a[k];
  return s;
}

// Hopper, Walker2D, HalfCheetah (planar root: rootx, rootz, rooty) and Ant,
// Humanoid (a free root): vx is the root x's position difference over the
// control step, divided (not multiplied by a reciprocal) as the plain
// version does. The free roots' zero blocks are not written here: obs[o]
// holds their value, 0 * x, which the caller repeats (obs_live = o).
ENG_HD void mj_walker_output(const Tables& t, const float* q, const float* v, const float* a,
                             const float* aux, float* obs, float& reward, bool& term,
                             float* aux2, float* comps) {
  const float x = q[0];
  const float vx = (x - aux[t.ax_x]) / t.control_dt;
  int o = 0;
  if (t.mj_free) {
    for (int j = 2; j < t.nq; ++j) obs[o++] = q[j];
    const V3 lin = m3_vec(m3_from_quat(q + 3), v3(v[3], v[4], v[5]));
    obs[o++] = lin.x;
    obs[o++] = lin.y;
    obs[o++] = lin.z;
    for (int d = 0; d < 3; ++d) obs[o++] = v[d];
    for (int d = 6; d < t.nv; ++d) obs[o++] = v[d];
    obs[o] = 0.f * x;
  } else {
    for (int j = 1; j < t.nq; ++j) obs[o++] = q[j];
    for (int d = 0; d < t.nv; ++d) obs[o++] = t.mj_clip_qvel ? jclip(v[d], -10.f, 10.f) : v[d];
  }
  const float ctrl = t.mj_ctrl * sum_sq(t.act, a);
  const float fwd = t.mj_fwd * vx;
  reward = t.mj_alive + fwd - ctrl;
  bool ok = true;
  if (t.mj_done == MJ_DONE_HOPPER) {
    ok = q[1] > (float)0.7 && fabsf(q[2]) < (float)0.2;
    for (int j = 2; j < t.nq; ++j) ok = ok && fabsf(q[j]) < 100.f;
    for (int d = 0; d < t.nv; ++d) ok = ok && fabsf(v[d]) < 100.f;
  } else if (t.mj_done == MJ_DONE_WALKER) {
    ok = q[1] > (float)0.8 && q[1] < 2.f && fabsf(q[2]) < 1.f;
  } else if (t.mj_done == MJ_DONE_ANT) {
    // the task's isfinite test on q and v is the caller's NaN guard's,
    // which ends every episode whose state is not finite
    ok = q[2] >= (float)0.2 && q[2] <= 1.f;
  } else if (t.mj_done == MJ_DONE_HUMANOID) {
    ok = q[2] > 1.f && q[2] < 2.f;
  }
  term = !ok;
  aux2[t.ax_x] = x;
  comps[t.cp_alive] = t.mj_alive + 0.f * (t.mj_free ? x : vx);
  comps[t.cp_ctrl_cost] = -ctrl;
  comps[t.cp_forward] = fwd;
}

// Reacher: act slots 0, 1 and jq/jv 0, 1 the joints, jq 2, 3 the target's
// slides; frames 0, 1: fingertip and target. Never terminates.
ENG_HD void mj_reacher_output(const Tables& t, const FK& fk, const float* q, const float* v,
                              const float* a, float* obs, float& reward, bool& term,
                              float* comps) {
  forward_kinematics(t, q, v, fk, nullptr);
  const V3 d = v3_sub(frame_point(t, fk, 0), frame_point(t, fk, 1));
  const float th0 = q[t.jq[0]], th1 = q[t.jq[1]];
  obs[0] = cosf(th0);
  obs[1] = cosf(th1);
  obs[2] = sinf(th0);
  obs[3] = sinf(th1);
  obs[4] = q[t.jq[2]];
  obs[5] = q[t.jq[3]];
  obs[6] = v[t.jv[0]];
  obs[7] = v[t.jv[1]];
  obs[8] = d.x;
  obs[9] = d.y;
  obs[10] = d.z;
  const float dist = -norm_eps(d), ctrl = -sum_sq(t.act, a);
  reward = dist + ctrl;
  term = false;
  comps[t.cp_dist] = dist;
  comps[t.cp_ctrl] = ctrl;
}

// InvertedPendulum (obs [q, v], reward 1, done |q1| > 0.2) and
// InvertedDoublePendulum (frame 0: the tip on pole2).
ENG_HD void mj_pendulum_output(const Tables& t, const FK& fk, const float* q, const float* v,
                               float* obs, float& reward, bool& term, float* comps) {
  if (t.task_kind == TASK_MJ_PENDULUM) {
    int o = 0;
    for (int j = 0; j < t.nq; ++j) obs[o++] = q[j];
    for (int d = 0; d < t.nv; ++d) obs[o++] = v[d];
    reward = 1.f;
    term = fabsf(q[1]) > (float)0.2;
    comps[t.cp_reward] = reward;
    return;
  }
  forward_kinematics(t, q, v, fk, nullptr);
  const V3 tip = frame_point(t, fk, 0);
  const float zero = 0.f * q[0];
  obs[0] = q[0];
  obs[1] = sinf(q[1]);
  obs[2] = sinf(q[2]);
  obs[3] = cosf(q[1]);
  obs[4] = cosf(q[2]);
  obs[5] = v[0];
  obs[6] = v[1];
  obs[7] = v[2];
  obs[8] = obs[9] = obs[10] = zero;
  const float h = tip.z - 2.f;
  const float dist_penalty = (float)0.01 * (tip.x * tip.x) + h * h;
  const float vel_penalty = (float)1e-3 * (v[1] * v[1]) + (float)5e-3 * (v[2] * v[2]);
  reward = 10.f - dist_penalty - vel_penalty;
  term = tip.z <= 1.f;
  comps[t.cp_alive] = 10.f + zero;
  comps[t.cp_dist_penalty] = -dist_penalty;
  comps[t.cp_vel_penalty] = -vel_penalty;
}

// ---- the two kernel bodies ---------------------------------------------------
// Every lane of env i's group calls them with the env's scratch `base`:
// ENG_ENV_SCRATCH.

// `frame_skip` substeps with held torques; depths of the last substep.
// pallas_engine.py · make_pallas_physics_step
template <int G>
ENG_HD void physics_step_one(const Tables& t, const Group<G>& g, float* base, int i, int B,
                             const float* q_in, const float* v_in, const float* tau_in,
                             float* q_out, float* v_out, float* d_out) {
  const Scr s = scratch(t, base);
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) s.q[k] = q_in[k * B + i];
    for (int k = l; k < t.nv; k += G) {
      s.v[k] = v_in[k * B + i];
      s.tau[k] = tau_in[k * B + i];
    }
    for (int r = l; r < t.nr; r += G) s.depth[r] = 0.f;
  }
  dofs_fill(t, g, s);
  g.sync();
  for (int st = 0; st < t.frame_skip; ++st) substep(t, g, s);
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) q_out[k * B + i] = s.q[k];
    for (int k = l; k < t.nv; k += G) v_out[k * B + i] = s.v[k];
    for (int r = l; r < t.nr; r += G) d_out[r * B + i] = s.depth[r];
  }
}

// The whole env step. pallas_engine.py · make_pallas_env_step
template <int G>
ENG_HD void env_step_one(const Tables& t, const EnvIO& io, const Group<G>& g,
                         float* base, int i, int B) {
  const Scr s = scratch(t, base);
  const bool done = io.term[i] != 0 || io.trunc[i] != 0;
  const uint32_t epoch = io.epoch[i] + (done ? 1u : 0u);
  const uint32_t seed = io.seed[i];
  const uint32_t env_id = (uint32_t)io.env_id[i];
  const int32_t step_count = done ? 0 : io.step_count[i];
  // every input in one phase, whether or not the env resets (a reset
  // overwrites q, v and every aux slot), so the loads share one round trip
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) s.q[k] = io.q[k * B + i];
    for (int k = l; k < t.nv; k += G) {
      s.v[k] = io.v[k * B + i];
      s.tau[k] = 0.f;
    }
    for (int k = l; k < t.naux; k += G) s.aux[k] = io.aux[k * B + i];
    for (int k = l; k < t.act; k += G) s.act[k] = jclip(io.act[k * B + i], -1.f, 1.f);
    for (int r = l; r < t.nr; r += G) s.depth[r] = 0.f;
  }
  dofs_fill(t, g, s);
  g.sync();
  if (g.leader()) {
    // auto-reset [ref: env_bases.py · BaseBulletEnv.reset], then the
    // pre-physics hook (FlagrunHarder's cube)
    if (done) initial_state(t, s.fk, seed, env_id, epoch, s.q, s.v, s.aux);
    if (t.task_kind == TASK_FLAGRUN_HARDER) cube_throw(t, seed, env_id, epoch, s.q, s.v, s.aux);
  }
  // torques [ref: WalkerBase.apply_action; the other tasks' apply_action]
  EACH_LANE(g, l) {
    for (int k = l; k < t.act; k += G) s.tau[t.act_dof[k]] = t.gain[k] * s.act[k];
  }
  g.sync();
  for (int st = 0; st < t.frame_skip; ++st) substep(t, g, s);

  // the task's outputs, the NaN guard and the scalars: one lane
  if (g.leader()) {
    float reward, aux2[MAX_AUX], comps[MAX_COMP];
    bool term;
    float* obs = s.obs;
    if (t.task_kind <= TASK_FLAGRUN_HARDER)
      walker_output(t, s.fk, seed, env_id, epoch, s.q, s.v, s.depth, s.act, s.aux, obs, reward,
                    term, aux2, comps);
    else if (t.task_kind == TASK_REACHER)
      reacher_output(t, s.fk, s.q, s.v, s.act, s.aux, obs, reward, term, aux2, comps);
    else if (t.task_kind <= TASK_THROWER)
      arm_output(t, s.fk, s.q, s.v, s.act, s.aux, obs, reward, term, aux2, comps);
    else if (t.task_kind <= TASK_DOUBLE_PENDULUM)
      pendulum_output(t, s.fk, s.q, s.v, obs, reward, term, comps);
    else if (t.task_kind == TASK_MJ_WALKER)
      mj_walker_output(t, s.q, s.v, s.act, s.aux, obs, reward, term, aux2, comps);
    else if (t.task_kind == TASK_MJ_REACHER)
      mj_reacher_output(t, s.fk, s.q, s.v, s.act, obs, reward, term, comps);
    else
      mj_pendulum_output(t, s.fk, s.q, s.v, obs, reward, term, comps);

    // NaN guard [ref: walker_base_env.py · step isfinite check]; obs[obs_live]
    // stands for the zero blocks where there are any
    const int nobs = t.obs_live < t.obs_dim ? t.obs_live + 1 : t.obs_dim;
    bool fin = finite(reward);
    for (int k = 0; k < nobs; ++k) fin = fin && finite(obs[k]);
    for (int k = 0; k < t.nq; ++k) fin = fin && finite(s.q[k]);
    for (int k = 0; k < t.nv; ++k) fin = fin && finite(s.v[k]);
    term = term || !fin;
    for (int k = 0; k < nobs; ++k) obs[k] = finite(obs[k]) ? obs[k] : 0.f;
    reward = finite(reward) ? reward : 0.f;
    const int32_t step2 = step_count + 1;
    const bool trunc = (step2 >= t.max_steps) && !term;
    io.reward[i] = reward;
    io.term_out[i] = term ? 1 : 0;
    io.trunc_out[i] = trunc ? 1 : 0;
    io.step_out[i] = step2;
    io.epoch_out[i] = epoch;
    for (int k = 0; k < t.naux; ++k) io.aux_out[k * B + i] = aux2[k];
    for (int k = 0; k < t.ncomp; ++k) io.comps[k * B + i] = comps[k];
  }
  g.sync();
  EACH_LANE(g, l) {
    for (int k = l; k < t.nq; k += G) io.q_out[k * B + i] = s.q[k];
    for (int k = l; k < t.nv; k += G) io.v_out[k * B + i] = s.v[k];
    for (int k = l; k < t.obs_dim; k += G) io.obs[k * B + i] = s.obs[k < t.obs_live ? k : t.obs_live];
  }
}

// Byte offset of every table field, in declaration order; the Python side
// checks its ctypes mirror against these.
inline int tables_layout(int32_t* out, int cap) {
  int n = 0;
#define ENG_OFF_S(T, name) if (n < cap) out[n] = (int32_t)offsetof(Tables, name); ++n;
#define ENG_OFF_A(T, name, k) if (n < cap) out[n] = (int32_t)offsetof(Tables, name); ++n;
  ENG_TABLE_FIELDS(ENG_OFF_S, ENG_OFF_A)
  ENG_WIN_FIELDS(ENG_OFF_S, ENG_OFF_A)
  ENG_PATH_FIELDS(ENG_OFF_S, ENG_OFF_A)
#undef ENG_OFF_S
#undef ENG_OFF_A
  return n;
}

}  // namespace eng
