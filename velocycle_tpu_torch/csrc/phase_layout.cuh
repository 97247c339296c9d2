// Launch layout of the phase-stage NB kernels (nb_phase.cu) and of the
// roofline ladder cut from them (nb_ladder.cu).
//
// One CTA of kThreads threads owns a tile of kCellsPerBlock cells
// (kCellsPerThread per thread, in registers) and sweeps every gene in
// chunks of kGeneChunk, staging each chunk's per-gene columns in shared
// memory.  The ladder's rungs must run in this layout, or they measure a
// different kernel than `phase_fwdgrad`.
#pragma once

namespace vct {
namespace phase_layout {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 2;
constexpr int kCellsPerBlock = kThreads * kCellsPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kGeneChunk = 32;

}  // namespace phase_layout
}  // namespace vct
