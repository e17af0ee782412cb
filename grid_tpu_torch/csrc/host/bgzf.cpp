#include "bgzf.h"

#include <zlib.h>

#include <cstring>

#include "bedwrite.h"  // LibDeflateApi (runtime-resolved libdeflate)

namespace gridtpu {

BgzfReader::~BgzfReader() { close(); }

bool BgzfReader::open(const char* path) {
  close();
  f_ = fopen(path, "rb");
  if (!f_) return false;
  block_addr_ = 0;
  next_addr_ = 0;
  ulen_ = upos_ = 0;
  loaded_ = false;
  ublock_.resize(1 << 16);
  return true;
}

void BgzfReader::close() {
  if (f_) fclose(f_);
  f_ = nullptr;
}

bool BgzfReader::load_block(int64_t coffset) {
  if (!f_) return false;
  if (fseeko(f_, coffset, SEEK_SET) != 0) return false;

  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f_) != 12) return false;
  if (hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 || !(hdr[3] & 4)) return false;
  uint16_t xlen = (uint16_t)hdr[10] | ((uint16_t)hdr[11] << 8);

  std::vector<uint8_t> extra(xlen);
  if (fread(extra.data(), 1, xlen, f_) != xlen) return false;

  int32_t bsize = -1;
  size_t off = 0;
  while (off + 4 <= xlen) {
    uint8_t si1 = extra[off], si2 = extra[off + 1];
    uint16_t slen = (uint16_t)extra[off + 2] | ((uint16_t)extra[off + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2 && off + 6 <= xlen) {
      bsize = ((int32_t)extra[off + 4] | ((int32_t)extra[off + 5] << 8)) + 1;
      break;
    }
    off += 4 + slen;
  }
  if (bsize < 12 + (int32_t)xlen + 8) return false;  // corrupt BC size

  size_t cdata_len = (size_t)bsize - 12 - xlen - 8;
  std::vector<uint8_t> cdata(cdata_len);
  if (fread(cdata.data(), 1, cdata_len, f_) != cdata_len) return false;

  uint8_t tail[8];
  if (fread(tail, 1, 8, f_) != 8) return false;
  uint32_t isize = (uint32_t)tail[4] | ((uint32_t)tail[5] << 8) | ((uint32_t)tail[6] << 16) |
                   ((uint32_t)tail[7] << 24);

  if (isize > (1u << 16)) return false;  // BGZF blocks are <= 64 KiB
  if (isize > ublock_.size()) ublock_.resize(isize);

  // raw-deflate block decode: libdeflate when present (~2x zlib)
  const LibDeflateApi& a = libdeflate_api();
  void* d = libdeflate_decompressor();
  if (d) {
    size_t actual = 0;
    if (a.deflate_decompress(d, cdata.data(), cdata_len, ublock_.data(),
                             ublock_.size(), &actual) != 0 ||
        actual != isize)
      return false;
  } else {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = cdata.data();
    zs.avail_in = (uInt)cdata_len;
    zs.next_out = ublock_.data();
    zs.avail_out = (uInt)ublock_.size();
    int ret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (ret != Z_STREAM_END || zs.total_out != isize) return false;
  }

  ulen_ = isize;
  upos_ = 0;
  block_addr_ = coffset;
  next_addr_ = coffset + bsize;
  loaded_ = true;
  return true;
}

bool BgzfReader::next_block() {
  int64_t addr = loaded_ ? next_addr_ : block_addr_;
  for (;;) {
    if (!load_block(addr)) return false;
    if (ulen_ > 0) return true;  // skip empty blocks (incl. EOF marker)
    addr = next_addr_;
  }
}

bool BgzfReader::read(void* dst, size_t n) {
  uint8_t* out = (uint8_t*)dst;
  while (n > 0) {
    if (!loaded_ || upos_ >= ulen_) {
      if (!next_block()) return false;
    }
    size_t avail = ulen_ - upos_;
    size_t take = avail < n ? avail : n;
    memcpy(out, ublock_.data() + upos_, take);
    upos_ += take;
    out += take;
    n -= take;
  }
  return true;
}

bool BgzfReader::skip(size_t n) {
  while (n > 0) {
    if (!loaded_ || upos_ >= ulen_) {
      if (!next_block()) return false;
    }
    size_t avail = ulen_ - upos_;
    size_t take = avail < n ? avail : n;
    upos_ += take;
    n -= take;
  }
  return true;
}

uint64_t BgzfReader::tell() const {
  if (!loaded_ || upos_ >= ulen_) {
    // position is the start of the next block
    return (uint64_t)(loaded_ ? next_addr_ : block_addr_) << 16;
  }
  return ((uint64_t)block_addr_ << 16) | (uint64_t)upos_;
}

bool BgzfReader::seek(uint64_t voffset) {
  int64_t coffset = (int64_t)(voffset >> 16);
  size_t uoffset = (size_t)(voffset & 0xffff);
  if (!loaded_ || coffset != block_addr_) {
    if (!load_block(coffset)) return false;
  }
  if (uoffset > ulen_) return false;
  upos_ = uoffset;
  return true;
}

bool BgzfReader::eof() {
  if (loaded_ && upos_ < ulen_) return false;
  // try to load the next non-empty block
  if (!next_block()) return true;
  return false;
}

}  // namespace gridtpu
