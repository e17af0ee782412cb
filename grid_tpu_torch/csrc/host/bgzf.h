// Minimal BGZF (blocked gzip) reader with virtual-offset seeking.
//
// BGZF is the container of BAM/BAI/tabix: a sequence of independent gzip
// members, each carrying a BC extra subfield with the compressed block size,
// enabling (coffset << 16 | uoffset) virtual-offset random access. This
// implementation needs only zlib — grid_tpu's native ingestion deliberately
// avoids an htslib dependency (SURVEY §2.4 plan).

#pragma once

#include <cstdint>
#include <cstdio>
#include <vector>

namespace gridtpu {

class BgzfReader {
 public:
  BgzfReader() = default;
  ~BgzfReader();

  bool open(const char* path);
  void close();

  // Sequential read across block boundaries. Returns false on EOF/error
  // before n bytes were delivered.
  bool read(void* dst, size_t n);

  // Skip n uncompressed bytes.
  bool skip(size_t n);

  // Virtual offset of the NEXT byte to be read.
  uint64_t tell() const;

  // Seek to a virtual offset (coffset << 16 | uoffset).
  bool seek(uint64_t voffset);

  // True when no further bytes are available.
  bool eof();

 private:
  bool load_block(int64_t coffset);  // inflate the block at file offset
  bool next_block();

  FILE* f_ = nullptr;
  std::vector<uint8_t> ublock_;  // current uncompressed block
  size_t ulen_ = 0;              // bytes in ublock_
  size_t upos_ = 0;              // cursor within ublock_
  int64_t block_addr_ = 0;       // file offset of current block
  int64_t next_addr_ = 0;        // file offset of the following block
  bool loaded_ = false;
};

}  // namespace gridtpu
