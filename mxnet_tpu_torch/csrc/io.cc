// Native data pipeline of the port: RecordIO parse + JPEG decode +
// augment + threaded double-buffered batching, behind
// mxnet_tpu_torch.io.ImageRecordIter.
//
// The port's own copy of the reference's host pipeline
// (mxnet_tpu/native/io.cc; ref: src/io/iter_image_recordio_2.cc ::
// ImageRecordIOParser2, src/io/image_aug_default.cc,
// iter_prefetcher.h, dmlc-core's recordio framing). It is host C++, not
// a kernel: no Pallas kernel stands behind it. The arithmetic is the
// reference's, step for step (the bilinear Resize, the crop and mirror
// draws from a per-record mt19937 seeded by seed ^ rec_id *
// 0x9E3779B97F), so the two pipelines give the same batches bit for
// bit. One change: a reset first lets the producer fill its free
// buffers (ImageRecordIter::Reset), so the epochs after a reset no
// longer depend on the threads' timing. The host emits NHWC uint8
// batches; the cast, normalize and layout change run on the card after
// the upload.
//
// Compiled at first use by mxnet_tpu_torch/native.py with
// g++ -O3 -fPIC -std=c++17 -pthread against the libjpeg ABI-62 headers
// in csrc/jpeg/, linked by full path to the libjpeg found at run time.
// Exposed through a small C ABI consumed via ctypes. Beyond the
// reference's ABI: MXIOJpegCheck creates and destroys one decompressor,
// so that a header/library mismatch fails at load time with libjpeg's
// own message, and MXIOJpegLibrary names the file that provides libjpeg.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <jpeglib.h>
#include <setjmp.h>

namespace {

// error string is written by worker threads and read from the consumer
// thread, so it's a mutex-guarded global (a thread_local would always
// read empty from the consumer); readers copy into a thread_local so
// the returned pointer stays stable
std::mutex g_err_mu;
std::string g_err_store;

struct ErrProxy {
  ErrProxy& operator=(const std::string& s) {
    std::lock_guard<std::mutex> lk(g_err_mu);
    g_err_store = s;
    return *this;
  }
  ErrProxy& operator=(std::string&& s) {
    std::lock_guard<std::mutex> lk(g_err_mu);
    g_err_store = std::move(s);
    return *this;
  }
};
ErrProxy g_last_error;

const char* ReadLastError() {
  thread_local std::string copy;
  std::lock_guard<std::mutex> lk(g_err_mu);
  copy = g_err_store;
  return copy.c_str();
}

constexpr uint32_t kMagic = 0xced7230a;

// ---------------------------------------------------------------- RecordIO
class RecordReader {
 public:
  bool Open(const std::string& path) {
    f_ = std::fopen(path.c_str(), "rb");
    if (!f_) { g_last_error = "cannot open " + path; return false; }
    return true;
  }
  ~RecordReader() { if (f_) std::fclose(f_); }

  void Seek(uint64_t pos) {
    std::fseek(f_, (long)pos, SEEK_SET);
    failed_ = false;
  }

  // step over one logical record without reading its payload; false
  // on EOF (a payload cut short shows as EOF at the next header)
  bool Skip() {
    bool multi = false;
    while (true) {
      uint32_t head[2];
      if (std::fread(head, 4, 2, f_) != 2) {
        failed_ = multi || !std::feof(f_);
        if (failed_) g_last_error = "truncated record header";
        return false;
      }
      if (head[0] != kMagic) {
        g_last_error = "bad magic";
        failed_ = true;
        return false;
      }
      uint32_t cflag = head[1] >> 29, len = head[1] & ((1u << 29) - 1);
      std::fseek(f_, (long)(len + (4 - len % 4) % 4), SEEK_CUR);
      if (cflag == 0 || cflag == 3) return true;
      multi = true;
    }
  }

  // true if the last Next() returned false due to corruption, not EOF
  bool Failed() const { return failed_; }

  // read one logical record (reassembling multi-part); false on EOF
  bool Next(std::vector<uint8_t>* out) {
    out->clear();
    bool multi = false;
    while (true) {
      uint32_t head[2];
      if (std::fread(head, 4, 2, f_) != 2) {
        failed_ = multi || !std::feof(f_);
        if (failed_) g_last_error = "truncated record header";
        return false;
      }
      if (head[0] != kMagic) {
        g_last_error = "bad magic";
        failed_ = true;
        return false;
      }
      uint32_t cflag = head[1] >> 29, len = head[1] & ((1u << 29) - 1);
      if (multi) {  // dmlc framing: magic re-inserted between chunks
        const uint8_t* m = reinterpret_cast<const uint8_t*>(&kMagic);
        out->insert(out->end(), m, m + 4);
      }
      size_t base = out->size();
      out->resize(base + len);
      if (len && std::fread(out->data() + base, 1, len, f_) != len) {
        g_last_error = "truncated record";
        failed_ = true;
        return false;
      }
      uint32_t pad = (4 - len % 4) % 4;
      if (pad) std::fseek(f_, pad, SEEK_CUR);
      if (cflag == 0 || cflag == 3) return true;
      multi = true;
    }
  }

 private:
  FILE* f_ = nullptr;
  bool failed_ = false;
};

// ------------------------------------------------------------------ JPEG
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
};

void JpegErrExit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->msg);
  longjmp(e->jb, 1);
}

bool DecodeJpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrExit;
  jerr.msg[0] = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    g_last_error = std::string("jpeg decode failed: ") + jerr.msg;
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize((size_t)(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + (size_t)cinfo.output_scanline * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// 0 if libjpeg accepts this build's headers (version and struct size),
// else -1 with libjpeg's message in the last error
int JpegCheck() {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrExit;
  jerr.msg[0] = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    g_last_error = std::string("libjpeg refused this build's headers: ") +
                   jerr.msg;
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// --------------------------------------------------------------- Augment
void Resize(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw, int dh) {
  const float xs = (float)sw / dw, ys = (float)sh / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[((size_t)y0 * sw + x0) * 3 + c];
        float v01 = src[((size_t)y0 * sw + x1) * 3 + c];
        float v10 = src[((size_t)y1 * sw + x0) * 3 + c];
        float v11 = src[((size_t)y1 * sw + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[((size_t)y * dw + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

struct AugmentCfg {
  int out_h, out_w;
  int resize_short;  // 0 = off
  bool rand_crop;
  bool rand_mirror;
};

bool ProcessImage(const uint8_t* payload, size_t len, const AugmentCfg& cfg,
                  std::mt19937* rng, uint8_t* dst) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (len >= 2 && payload[0] == 0xFF && payload[1] == 0xD8) {
    if (!DecodeJpeg(payload, len, &rgb, &w, &h)) return false;
  } else if (len == (size_t)cfg.out_h * cfg.out_w * 3) {
    // raw pass-through record already at target size
    std::memcpy(dst, payload, len);
    if (cfg.rand_mirror && ((*rng)() & 1)) {
      for (int y = 0; y < cfg.out_h; ++y) {
        uint8_t* row = dst + (size_t)y * cfg.out_w * 3;
        for (int x = 0; x < cfg.out_w / 2; ++x) {
          for (int c = 0; c < 3; ++c)
            std::swap(row[(size_t)x * 3 + c],
                      row[(size_t)(cfg.out_w - 1 - x) * 3 + c]);
        }
      }
    }
    return true;
  } else {
    g_last_error = "record is neither JPEG nor raw of expected size";
    return false;
  }
  std::vector<uint8_t> tmp;
  if (cfg.resize_short > 0) {
    int nw, nh;
    if (w < h) { nw = cfg.resize_short; nh = (int)((int64_t)h * nw / w); }
    else       { nh = cfg.resize_short; nw = (int)((int64_t)w * nh / h); }
    if (nw != w || nh != h) {
      tmp.resize((size_t)nw * nh * 3);
      Resize(rgb.data(), w, h, tmp.data(), nw, nh);
      rgb.swap(tmp);
      w = nw; h = nh;
    }
  }
  int cw = cfg.out_w, ch = cfg.out_h;
  if (w < cw || h < ch) {  // upscale undersized inputs
    tmp.resize((size_t)cw * ch * 3);
    Resize(rgb.data(), w, h, tmp.data(), cw, ch);
    rgb.swap(tmp);
    w = cw; h = ch;
  }
  int x0 = (w - cw) / 2, y0 = (h - ch) / 2;
  if (cfg.rand_crop && (w > cw || h > ch)) {
    x0 = (int)((*rng)() % (uint32_t)(w - cw + 1));
    y0 = (int)((*rng)() % (uint32_t)(h - ch + 1));
  }
  bool mirror = cfg.rand_mirror && ((*rng)() & 1);
  for (int y = 0; y < ch; ++y) {
    const uint8_t* srow = rgb.data() + ((size_t)(y0 + y) * w + x0) * 3;
    uint8_t* drow = dst + (size_t)y * cw * 3;
    if (!mirror) {
      std::memcpy(drow, srow, (size_t)cw * 3);
    } else {
      for (int x = 0; x < cw; ++x) {
        const uint8_t* s = srow + (size_t)(cw - 1 - x) * 3;
        drow[(size_t)x * 3 + 0] = s[0];
        drow[(size_t)x * 3 + 1] = s[1];
        drow[(size_t)x * 3 + 2] = s[2];
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------- Iterator
#pragma pack(push, 1)
struct IRHeaderRaw {
  uint32_t flag;
  float label;
  uint64_t id, id2;
};
#pragma pack(pop)
static_assert(sizeof(IRHeaderRaw) == 24, "IRHeader layout");

struct Batch {
  std::vector<uint8_t> data;  // N*H*W*3 NHWC u8
  std::vector<float> label;   // N*label_width
  int n = 0;
};

// Double-buffered producer/consumer:
//   free_q_  -> producer fills -> ready_q_ -> consumer -> back to free_q_
// An epoch boundary is a nullptr marker in ready_q_.
class ImageRecordIter {
 public:
  ImageRecordIter(std::string rec, std::string idx, int batch, int h, int w,
                  int label_width, bool shuffle, AugmentCfg aug,
                  int num_threads, uint64_t seed)
      : rec_path_(std::move(rec)), idx_path_(std::move(idx)), batch_(batch),
        h_(h), w_(w), label_width_(label_width), shuffle_(shuffle), aug_(aug),
        threads_(num_threads < 1 ? 1 : num_threads), seed_(seed) {
    for (int i = 0; i < 3; ++i) {
      pool_[i].data.resize((size_t)batch_ * h_ * w_ * 3);
      pool_[i].label.resize((size_t)batch_ * label_width_);
      free_q_.push_back(&pool_[i]);
    }
  }

  bool Init() {
    if (shuffle_ && !LoadIndex()) return false;
    {
      RecordReader probe;  // fail fast on a bad path
      if (!probe.Open(rec_path_)) return false;
    }
    worker_ = std::thread([this] { Produce(); });
    started_ = true;
    return true;
  }

  ~ImageRecordIter() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_prod_.notify_all();
    cv_cons_.notify_all();
    if (started_) worker_.join();
  }

  // 0 = batch delivered, 1 = end of epoch, -1 = error
  int Next(uint8_t** data, float** label, int* n) {
    std::unique_lock<std::mutex> lk(mu_);
    if (held_) {  // recycle the batch the consumer finished with
      free_q_.push_back(held_);
      held_ = nullptr;
      cv_prod_.notify_all();
    }
    cv_cons_.wait(lk, [this] { return !ready_q_.empty() || err_; });
    if (err_ && ready_q_.empty()) return -1;
    Batch* b = ready_q_.front();
    ready_q_.pop_front();
    if (b == nullptr) return 1;  // epoch marker
    held_ = b;
    *data = b->data.data();
    *label = b->label.data();
    *n = b->n;
    return 0;
  }

  // The producer runs ahead of the consumer, and every record it reads
  // takes the next record id, which seeds that record's draws. So a
  // reset first lets the producer fill every free buffer (stepping over
  // the records, unread: the reset drains them): how far it
  // ran ahead, and so the ids and shuffles after the reset, are then the
  // same in every run. (The reference resets at once, so its epochs
  // after a reset depend on the threads' timing; it agrees with this
  // whenever its consumer is the slower side.)
  void Reset() {
    std::unique_lock<std::mutex> lk(mu_);
    draining_ = true;
    cv_cons_.wait(lk, [this] {
      return (free_q_.empty() && !busy_) || err_ || stop_;
    });
    draining_ = false;
    reset_req_ = true;
    cv_prod_.notify_all();
    cv_cons_.wait(lk, [this] { return reset_done_ || err_; });
    // drain anything queued before the ack
    while (!ready_q_.empty()) {
      Batch* b = ready_q_.front();
      ready_q_.pop_front();
      if (b) free_q_.push_back(b);
    }
    if (held_) {
      free_q_.push_back(held_);
      held_ = nullptr;
    }
    reset_done_ = false;
    cv_prod_.notify_all();
  }

 private:
  bool LoadIndex() {
    FILE* f = std::fopen(idx_path_.c_str(), "r");
    if (!f) { g_last_error = "cannot open idx " + idx_path_; return false; }
    char key[256];
    unsigned long long pos;
    while (std::fscanf(f, "%255s %llu", key, &pos) == 2)
      offsets_.push_back(pos);
    std::fclose(f);
    if (offsets_.empty()) { g_last_error = "empty idx"; return false; }
    return true;
  }

  void Produce() {
    std::mt19937 rng((uint32_t)seed_);
    RecordReader reader;
    if (!reader.Open(rec_path_)) {
      std::lock_guard<std::mutex> lk(mu_);
      err_ = true;
      cv_cons_.notify_all();
      return;
    }
    std::vector<size_t> order(shuffle_ ? offsets_.size() : 0);
    size_t cursor = 0;
    auto restart = [&] {
      cursor = 0;
      if (shuffle_) {
        for (size_t i = 0; i < order.size(); ++i) order[i] = i;
        std::shuffle(order.begin(), order.end(), rng);
      } else {
        reader.Seek(0);
      }
    };
    restart();

    // one buffer a record of a batch, kept from batch to batch with its
    // capacity, so that reading a record allocates nothing
    std::vector<std::vector<uint8_t>> recs(batch_);
    while (true) {
      Batch* b = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_prod_.wait(lk, [&] {
          return stop_ || reset_req_ || !free_q_.empty();
        });
        if (stop_) return;
        if (reset_req_) {
          restart();
          reset_req_ = false;
          reset_done_ = true;
          cv_cons_.notify_all();
          // wait for the consumer to finish draining
          cv_prod_.wait(lk, [&] { return stop_ || !reset_done_; });
          if (stop_) return;
          continue;
        }
        b = free_q_.front();
        free_q_.pop_front();
        busy_ = true;
      }
      // ---- fill the batch outside the lock ----
      // a batch taken while a reset waits is drained by it: it only
      // steps over its records, taking their ids (see Reset)
      bool drained;
      {
        std::lock_guard<std::mutex> lk(mu_);
        drained = draining_;
      }
      // phase 1: serial record IO
      std::vector<uint64_t> rec_ids;
      bool epoch_end = false, io_err = false;
      while ((int)rec_ids.size() < batch_) {
        std::vector<uint8_t>& rec = recs[rec_ids.size()];
        bool ok;
        if (shuffle_) {
          if (cursor >= order.size()) { epoch_end = true; break; }
          if (drained) {
            ++cursor;
            ok = true;
          } else {
            reader.Seek(offsets_[order[cursor]]);
            ++cursor;
            ok = reader.Next(&rec);
          }
        } else {
          ok = drained ? reader.Skip() : reader.Next(&rec);
        }
        if (!ok) {
          if (reader.Failed()) io_err = true;
          else epoch_end = true;
          break;
        }
        rec_ids.push_back(counter_++);
      }
      if (io_err) {
        std::lock_guard<std::mutex> lk(mu_);
        err_ = true;
        cv_cons_.notify_all();
        return;
      }
      // phase 2: decode+augment, parallel over records
      size_t nrec = drained ? 0 : rec_ids.size();
      std::vector<uint8_t> okflag(nrec, 0);
      auto work = [&](size_t i) {
        const auto& r = recs[i];
        if (r.size() < sizeof(IRHeaderRaw)) return;
        IRHeaderRaw hd;
        std::memcpy(&hd, r.data(), sizeof(hd));
        const uint8_t* payload = r.data() + sizeof(hd);
        size_t plen = r.size() - sizeof(hd);
        float* lab = b->label.data() + i * label_width_;
        if (hd.flag > 0) {
          size_t nl = std::min<size_t>(hd.flag, (size_t)label_width_);
          if (plen < (size_t)hd.flag * 4) return;
          std::memcpy(lab, payload, nl * 4);
          for (size_t k = nl; k < (size_t)label_width_; ++k) lab[k] = 0.f;
          payload += (size_t)hd.flag * 4;
          plen -= (size_t)hd.flag * 4;
        } else {
          lab[0] = hd.label;
          for (int k = 1; k < label_width_; ++k) lab[k] = 0.f;
        }
        // per-record deterministic rng: reproducible regardless of
        // thread scheduling
        std::mt19937 rrng((uint32_t)(seed_ ^ (rec_ids[i] * 0x9E3779B97FULL)));
        uint8_t* dst = b->data.data() + i * (size_t)h_ * w_ * 3;
        if (ProcessImage(payload, plen, aug_, &rrng, dst)) okflag[i] = 1;
      };
      if (threads_ <= 1 || nrec < 2) {
        for (size_t i = 0; i < nrec; ++i) work(i);
      } else {
        std::atomic<size_t> next_i{0};
        int nt = std::min<int>(threads_, (int)nrec);
        std::vector<std::thread> pool;
        pool.reserve(nt);
        for (int t = 0; t < nt; ++t)
          pool.emplace_back([&] {
            size_t i;
            while ((i = next_i.fetch_add(1)) < nrec) work(i);
          });
        for (auto& th : pool) th.join();
      }
      // phase 3: compact failed slots
      b->n = 0;
      const size_t imgsz = (size_t)h_ * w_ * 3;
      for (size_t i = 0; i < nrec; ++i) {
        if (!okflag[i]) continue;
        if ((size_t)b->n != i) {
          std::memcpy(b->data.data() + (size_t)b->n * imgsz,
                      b->data.data() + i * imgsz, imgsz);
          std::memcpy(b->label.data() + (size_t)b->n * label_width_,
                      b->label.data() + i * label_width_,
                      (size_t)label_width_ * 4);
        }
        ++b->n;
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        busy_ = false;
        if (b->n > 0 || (drained && !rec_ids.empty()))
          ready_q_.push_back(b);
        else
          free_q_.push_back(b);
        if (epoch_end) {
          ready_q_.push_back(nullptr);  // epoch marker
          restart();
        }
        cv_cons_.notify_all();
      }
    }
  }

  std::string rec_path_, idx_path_;
  int batch_, h_, w_, label_width_;
  bool shuffle_;
  AugmentCfg aug_;
  int threads_;
  uint64_t seed_;
  uint64_t counter_ = 0;
  std::vector<uint64_t> offsets_;

  Batch pool_[3];
  std::deque<Batch*> free_q_, ready_q_;
  Batch* held_ = nullptr;
  bool stop_ = false, err_ = false, busy_ = false, draining_ = false;
  bool reset_req_ = false, reset_done_ = false;
  std::mutex mu_;
  std::condition_variable cv_prod_, cv_cons_;
  std::thread worker_;
  bool started_ = false;
};

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

const char* MXIOGetLastError() { return ReadLastError(); }

int MXIOJpegCheck() { return JpegCheck(); }

// the file that provides libjpeg's symbols to this library, or "" if
// the dynamic loader cannot say
const char* MXIOJpegLibrary() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&jpeg_CreateDecompress), &info) &&
      info.dli_fname)
    return info.dli_fname;
  return "";
}

void* MXIOCreateImageRecordIter(const char* rec, const char* idx, int batch,
                                int h, int w, int label_width, int shuffle,
                                int rand_crop, int rand_mirror,
                                int resize_short, int num_threads,
                                uint64_t seed) {
  AugmentCfg aug{h, w, resize_short, rand_crop != 0, rand_mirror != 0};
  auto* it = new ImageRecordIter(rec, idx ? idx : "", batch, h, w,
                                 label_width, shuffle != 0, aug, num_threads,
                                 seed);
  if (!it->Init()) {
    delete it;
    return nullptr;
  }
  return it;
}

int MXIONext(void* handle, uint8_t** data, float** label, int* n) {
  return static_cast<ImageRecordIter*>(handle)->Next(data, label, n);
}

void MXIOReset(void* handle) { static_cast<ImageRecordIter*>(handle)->Reset(); }

void MXIOFree(void* handle) { delete static_cast<ImageRecordIter*>(handle); }

}  // extern "C"
