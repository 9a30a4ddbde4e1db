// The last conv of each dense block of an RRDB trunk on Hopper (sm_90a),
// chained through the blocks' feature buffers: with dense_block.cu's
// convs 1..n-1, the launches of ops/dense_block.dense_block_chain.
//
// Three channels-last feature buffers (B, H, W, c_total) serve every
// block of the trunk.  The wrapper copies the trunk's input into channels
// [0, C) of the first.  Convs 1..n-1 of a block write their slices of the
// block's buffer (dense_block_conv of dense_block.cu).  Conv n, here, is
// the same Hopper tile (conv3x3_wgmma.cuh: the same kernels under the
// same names) with the kChain epilogue: it reads x from channels [0, C)
// of the block's buffer and writes
//   y = x + res_scale * conv_n
// into channels [0, C) of the next block's buffer; where the block ends an
// RRDB it writes the RRDB's residual x_o + round(res_scale * y) instead,
// x_o read from the RRDB's first buffer, which it writes over (each piece
// is read by the lane that then writes it, and no other tile of the launch
// reads that buffer).  An RRDB of one block reads x_o as its own x.  So the
// trunk's features cross device memory once per block, where block by
// block each one was copied into a buffer of its own and each RRDB's
// residual took two more passes.  The values round where the per-block
// path rounds them: y as dense_block.cu does, then PyTorch's multiply and
// add in bf16.
//
// A source of its own, which compiles the chained epilogue and not the
// residual ones (WGC_EPILOGUE_CHAIN): compiled into dense_block.cu, the
// chained epilogue slowed every kernel there by 2-5 %, and the growth
// convs run faster from dense_block.cu's kernels than from these
// (PERF.md).  bf16 only; float32 models keep the per-block path.

#define WGC_EPILOGUE WGC_EPILOGUE_CHAIN
#include "conv3x3_wgmma.cuh"

// Conv n of a block on the chain: y, or with ``outer``
// (wgc::kOuterAtOut, wgc::kOuterIsX) the RRDB's residual, from the
// block's buffer ``buf`` into channels [0, cout) of ``out``, the next
// block's buffer.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int dense_block_conv_chain(const void* buf, int c_total,
                                      const void* w, const void* bias,
                                      int cout, void* out, int outer,
                                      int batch, int h, int w_img,
                                      float res_scale, void* stream) {
  if (cout < 1 || cout > c_total || batch < 1 || batch > 65535 || h < 1 ||
      w_img < 1 || outer < 0 || outer > wgc::kOuterIsX || out == buf)
    return (int)cudaErrorInvalidValue;
  wgc::Conv c{buf, c_total, c_total, w, cout,
              static_cast<const float*>(bias), out, c_total, 0, outer, 0.f,
              wgc::kChain, buf, res_scale, batch, h, w_img};
  return wgc::launch<__nv_bfloat16, 64>(c, static_cast<cudaStream_t>(stream));
}
